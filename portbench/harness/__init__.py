"""The benchmark's harness: lookup by name, weights, traffic, the
measured window, trace arithmetic, work counts and the result line."""

"""Plain references the benchmark holds the program's outputs against.
They import neither JAX nor anything of the program under test."""

"""Device-mesh parallelism on ``torch.distributed``: the mesh, tensor-
parallel partition rules, ring and Ulysses attention, the pipeline
schedule, the multi-host bootstrap, and a launcher for a group of ranks on
one machine. Every rank runs the same program on its own shards; the
collectives are explicit (:mod:`.collectives`)."""

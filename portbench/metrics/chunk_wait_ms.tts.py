"""The host's reads a stream chunk: the ``stream.dones`` (the chunk's
flags) and ``stream.read`` (its samples) spans of the traced part, summed,
over the chunks read, in ms."""

from portbench.harness.spans import host_ms, traced


def read(ctx, run):
    reads = traced("stream.read")
    if not reads:
        return None
    waits = traced("stream.dones", "stream.read")
    return sum(host_ms(s) for s in waits if s["end_ns"] is not None) / len(
        reads)

"""The device's share of a stream's first audio: the union of the
intervals of the kernels launched before its first chunk reached the
host (the prefill, the first chains, the first emission), the mean over
the traced packets, in ms. A union, not the first kernel's start to the
last's end: that extent would count the host's reads between chains."""

from portbench.harness.readers import span_ms


def read(ctx, run):
    return span_ms(run, "first_chunk")

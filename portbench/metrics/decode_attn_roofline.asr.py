"""The decode attention's share of its roofline on the send path: the
least time of its launches in the traced part (each at its valid cache
length; keys and values read once, the queries read and the output
written) over the time its kernels took, in per cent."""

from portbench.harness.readers import roofline


def read(ctx, run):
    return roofline(run, "decode_attn")

"""The mixed linear's share of its roofline: the least time of the AR
steps' 123 linears (float32 rows, bfloat16 weights; operations at 989
TFLOP/s or bytes at 3.35 TB/s, each launch's larger) over the time its
kernels took in the traced part, in per cent."""

from portbench.harness.readers import roofline


def read(ctx, run):
    return roofline(run, "mixed_linear")

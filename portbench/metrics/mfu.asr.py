"""The whole send step's share of the card's peak over the window: for
every forward pass the window completed (the encoder at its bucket, the
prefill, each greedy step, every padded lane), the larger of operations
over 989 TFLOP/s and least bytes over 3.35 TB/s, summed, over the
window's wall time, in per cent."""

from portbench.harness.readers import mfu


def read(ctx, run):
    return mfu(ctx, run, "mfu.asr")

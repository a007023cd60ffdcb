"""The whole receive step's share of the card's peak over the window:
for every forward pass the window completed (each packet's prefill, each
AR step the program counted, the vocoder over the frames each packet
vocoded), the larger of operations over 989 TFLOP/s and least bytes
over 3.35 TB/s, summed, over the window's wall time, in per cent."""

from portbench.harness.readers import mfu


def read(ctx, run):
    return mfu(ctx, run, "mfu.tts")

"""Seconds of speech carried per wall second over the whole window, on
the receive path: the PCM of every packet the window completed, to its
text's duration cap, over the window's length."""

from portbench.harness.readers import speech_s_per_s


def read(ctx, run):
    return speech_s_per_s(run)

"""Seconds of speech carried per wall second over the whole window, on
the send path: the input audio of every phrase the window encoded, over
the window's length."""

from portbench.harness.readers import speech_s_per_s


def read(ctx, run):
    return speech_s_per_s(run)

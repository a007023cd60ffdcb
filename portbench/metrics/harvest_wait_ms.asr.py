"""The host blocked on the card in the harvest: the median ``encode.read``
span (the blocking reads of a batch's tokens and prosody) of the traced
part's harvests, in ms."""

from portbench.harness.spans import median_host_ms


def read(ctx, run):
    return median_host_ms("encode.read")

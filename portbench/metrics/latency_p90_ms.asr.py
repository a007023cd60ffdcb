"""The 90th percentile (nearest rank) of every phrase's time in the
window, from its batch's submit call to its batch's result on the host;
a failed phrase misses every limit."""

from portbench.harness.readers import p90_ms


def read(ctx, run):
    return p90_ms(run)

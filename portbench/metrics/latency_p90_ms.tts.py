"""The 90th percentile (nearest rank) of every packet's time in the
window, from the synthesis call to its last PCM byte on the host; a
failed packet misses every limit."""

from portbench.harness.readers import p90_ms


def read(ctx, run):
    return p90_ms(run)

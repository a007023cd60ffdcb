"""The 90th percentile (nearest rank) of every streamed packet's time
from the call to its first PCM chunk on the host."""

from portbench.harness.readers import p90_ms


def read(ctx, run):
    if not run.records or "t_first" not in run.records[0]:
        return None
    return p90_ms(run, end="t_first")

"""The program's own time to bucket, pad and put a batch in its wire
dtype: the median ``encode.pad`` span of the traced part's submits, in
ms."""

from portbench.harness.spans import median_host_ms


def read(ctx, run):
    return median_host_ms("encode.pad")

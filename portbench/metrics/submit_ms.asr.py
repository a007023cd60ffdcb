"""The median time of ``encode_batch_submit`` in the window on the
benchmark's clock: bucketing, padding, the int16 wire, the pinned upload
and the launches, before the handle returns."""

import statistics


def read(ctx, run):
    times = [r["submit_s"] for r in run.records if r["lane"] == 0]
    return 1e3 * statistics.median(times) if times else None

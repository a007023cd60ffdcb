"""The captured front's time on the card a batch: the mean device time
of the traced part's ``encode.front`` spans (timing events around the
front's replay, on the host's clock), in ms.

Not listed in ``BENCHMARK.json``'s ``per_layer`` yet: in a ``--trace 1``
run the spans are recorded under the profiler, whose cost between
kernels the device time then holds; it is for a runner that traces its
window with the program's tracer alone."""

from portbench.harness.spans import device_ms, traced


def read(ctx, run):
    times = [t for s in traced("encode.front")
             for t in [device_ms(s)] if t is not None]
    return sum(times) / len(times) if times else None

"""The greedy loop's time on the card a body: the device time of the
traced part's ``encode.loop`` spans (timing events around each WHILE
launch) over the bodies they ran (their ``trips``), in ms; the WHILE
node's own cost is in it.

Not listed in ``BENCHMARK.json``'s ``per_layer`` yet: in a ``--trace 1``
run the spans are recorded under the profiler, whose cost between
kernels the device time then holds; it is for a runner that traces its
window with the program's tracer alone."""

from portbench.harness.spans import device_ms, traced


def read(ctx, run):
    spent = trips = 0
    for s in traced("encode.loop"):
        t, n = device_ms(s), s["attrs"].get("trips")
        if t is not None and n:
            spent, trips = spent + t, trips + n
    return spent / trips if trips else None

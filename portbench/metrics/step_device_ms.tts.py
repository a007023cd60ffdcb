"""The AR step's time on the card: the device time of the traced part's
``stream.decode`` spans (a chain launch) and ``synth.loop`` spans (the
WHILE part of a synthesis launch, between its boundary events) over the
steps they ran (``steps``), in ms; the chain's or the WHILE node's own
cost is in it.

Not listed in ``BENCHMARK.json``'s ``per_layer`` yet: in a ``--trace 1``
run the spans are recorded under the profiler, whose cost between
kernels the device time then holds; it is for a runner that traces its
window with the program's tracer alone."""

from portbench.harness.spans import device_ms, traced


def read(ctx, run):
    spent = steps = 0
    for s in traced("stream.decode", "synth.loop"):
        t, n = device_ms(s), s["attrs"].get("steps")
        if t is not None and n:
            spent, steps = spent + t, steps + n
    return spent / steps if steps else None

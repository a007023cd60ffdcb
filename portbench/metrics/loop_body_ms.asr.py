"""The greedy loop's device time over the loop bodies that ran
(``LoopGraph.trips_run``), in ms a body: the union of the intervals of
the loop bodies' kernels over the traced batches."""

from portbench.harness.readers import span_ms


def read(ctx, run):
    return span_ms(run, "loop_body")

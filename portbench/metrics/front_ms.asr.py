"""The device span of the captured front a batch (the wire decode to the
first token: the first graph launch of each traced submit), the mean
over the traced batches, in ms."""

from portbench.harness.readers import span_ms


def read(ctx, run):
    return span_ms(run, "front")

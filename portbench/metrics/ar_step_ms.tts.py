"""The AR step's device time, in ms a step, over the steps the program
counted: the union of the driver's AR-step work (a stream's chain
launches, a synthesis's loop bodies)."""

from portbench.harness.readers import span_ms


def read(ctx, run):
    return span_ms(run, "ar_step")

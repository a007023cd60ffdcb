"""From the process's start to the first timed request: imports, the
kernels' build where the checkout has none, the weights, the program's
construction and the warm-up of the cell's shapes."""


def read(ctx, run):
    return run.setup_s

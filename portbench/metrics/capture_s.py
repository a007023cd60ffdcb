"""The set-up's graph work: the program's ``setup.capture`` (each step,
front, prefill, tail or emission graph's warm-up and capture) and
``setup.build`` (each loop or chain graph's build) spans that ended
before the window's first request, summed, in seconds. The traced part's
spans, summed by name, and the set-up's (kernel builds and loads, graph
captures and builds, warm-ups) go to standard error."""

from portbench.harness.spans import host_ms, setup, setup_summary, summary


def read(ctx, run):
    summary(ctx)
    setup_summary(ctx, run)
    spans = setup(run, "setup.capture", "setup.build")
    return sum(host_ms(s) for s in spans) / 1e3 if spans else None

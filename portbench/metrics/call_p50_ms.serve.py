"""Serving entry `FlowDiffusion.sample_video`: the median of every call of the window, host clock, ms."""

from portbench.harness import readers


def read(run):
    return readers.percentile_ms(run, 50)

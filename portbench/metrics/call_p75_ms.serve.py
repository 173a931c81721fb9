"""Serving entry `FlowDiffusion.sample_video`: the 75th percentile of every call of the window, host clock, ms.

A 51 s window holds about 42 calls of 1.23 s, so about ten lie beyond it;
`calls.serve` gives the count beside it."""

from portbench.harness import readers


def read(run):
    return readers.percentile_ms(run, 75)

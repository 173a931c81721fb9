"""Device: share of the traced calls with no device activity, %."""

from portbench.harness import readers


def read(run):
    return readers.idle_pct(run)

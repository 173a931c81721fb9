"""Dynamic threshold of each DDIM step (`GaussianDiffusion._maybe_threshold`, `ops/quantile.py`): device ms per call launched inside the program spans `lfdm::threshold`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "threshold")

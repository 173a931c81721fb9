"""Frozen LFAE, `FlowDiffusion.pseudo_ground_truth`: device ms per step inside it."""

from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "pseudo_ground_truth")

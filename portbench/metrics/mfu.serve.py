"""Whole call: product FLOPs (counted over the reference) per second of the window against 989 TFLOP/s bf16, %."""

from portbench.harness import readers


def read(run):
    return readers.mfu_pct(run, "bfloat16")

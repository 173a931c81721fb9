"""Rows 1-2 (`fused_temporal_layer`, `fused_spatial_linear_layer`): their calls' least time against the bf16 peak and the bandwidth over their device time, %."""

from portbench.harness import readers


def read(run):
    return readers.roofline_pct(run, ("fused_temporal_layer", "fused_spatial_linear_layer"),
                               ("fused_temporal_layer", "fused_spatial_linear_layer"), "bfloat16")

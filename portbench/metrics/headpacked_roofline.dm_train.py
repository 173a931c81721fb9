"""Rows 4-5 (`headpacked_attention.cu`, forward and backward): their calls' least time against the bf16 peak and the bandwidth over their device time, %."""

from portbench.harness import readers


def read(run):
    return readers.roofline_pct(run, ("headpacked_temporal_attention", "headpacked_temporal_attention.backward"),
                               ("headpacked_fwd", "headpacked_bwd"), "bfloat16")

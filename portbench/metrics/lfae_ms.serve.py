"""LFAE encode and decode (`generator.py`, row 3): device ms per call inside `compute_fea`, `decode_latent` and `decode_flow_video`."""

from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "compute_fea", "decode_latent", "decode")

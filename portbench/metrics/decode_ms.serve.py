"""LFAE decode (`decode_latent` and `decode_flow_video`, row 3): device ms per call launched inside the program span `lfdm::decode`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "decode")

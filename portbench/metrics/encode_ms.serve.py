"""LFAE encoder (`FlowDiffusion.sample_video` around `generator.compute_fea`): device ms per call launched inside the program span `lfdm::encode`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "encode")

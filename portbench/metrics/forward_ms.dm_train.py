"""UNet forward and loss (`FlowDiffusion.loss` past the pseudo ground truth): device ms per step launched inside the program span `lfdm::forward`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "forward")

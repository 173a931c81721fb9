"""UNet backward (`loss.backward()`, rows 4-5 backward): device ms per step launched on any thread while the program span `lfdm::backward` was open (autograd launches from its device thread)."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "backward")

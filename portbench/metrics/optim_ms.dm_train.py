"""Optimizer (`DMTrainer.train_step` from the gradient reductions through Adam): device ms per step launched inside the program span `lfdm::optimizer`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "optimizer")

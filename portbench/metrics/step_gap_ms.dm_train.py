"""DM step (`DMTrainer.train_step`): device idle ms per step in the gaps that began while the host was inside the program span `lfdm::train_step`."""

from portbench.harness import program


def read(run):
    return program.gap_ms(run, "train_step")

"""Host dispatch: device activities (kernels, copies, sets) per call."""

from portbench.harness import readers


def read(run):
    return readers.launches(run)

"""PyTorch's elementwise kernels over the whole call (the unfused Block chains, casts, the LFAE's BatchNorm passes): device ms per call in the `elementwise` kernel group."""

from portbench.harness import readers


def read(run):
    return readers.group_ms(run, "elementwise")

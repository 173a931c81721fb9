"""Sampler and UNet (`gaussian_diffusion.py` + `unet3d.py`): device ms per call launched inside `diffusion.sample`."""

from portbench.harness import readers


def read(run):
    return readers.span_ms(run, "sample")

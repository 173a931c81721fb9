"""UNet denoiser calls of the sampler: device activities (kernels, copies, sets) per call launched inside the program spans `lfdm::denoise`."""

from portbench.harness import program


def read(run):
    return program.span_launches(run, "denoise")

"""UNet denoiser calls of the sampler (`GaussianDiffusion._guided_pred`, rows 1-2): device ms per call launched inside the program spans `lfdm::denoise`."""

from portbench.harness import program


def read(run):
    return program.span_ms(run, "denoise")

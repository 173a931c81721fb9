"""Row 7, the UNet Blocks' fused conv bias + GroupNorm + FiLM + SiLU (`csrc/groupnorm_film_silu.cu`): device ms per call in the `groupnorm_film_silu` kernel group; nothing where no Block runs fused."""

from portbench.harness import readers


def read(run):
    return readers.group_ms(run, "groupnorm_film_silu")

"""The three stage-1 (LFAE) modules from a typed config, and their seeded
initialisation (counterpart of `cvpr23_lfdm_tpu/models/flow_autoenc.py`:
`build_lfae_modules`, `init_lfae_vars`). The composite `FlowAE` forward
belongs to LFAE training and is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvpr23_lfdm_torch.config import LFAEConfig
from cvpr23_lfdm_torch.models.bg_predictor import BGMotionPredictor
from cvpr23_lfdm_torch.models.generator import Generator
from cvpr23_lfdm_torch.models.region_predictor import RegionPredictor

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_generator(cfg: LFAEConfig, with_flow_predictor: bool = True) -> Generator:
    """The generator in eval mode, with or without its pixelwise flow
    predictor (serving decodes sampled flows and has no use for it)."""
    dtype = _DTYPES[cfg.compute_dtype]
    g = cfg.generator
    pf = None
    if with_flow_predictor:
        pf = dataclasses.asdict(g.pixelwise_flow)
        pf["dtype"] = dtype
    return Generator(
        num_channels=cfg.num_channels, block_expansion=g.block_expansion,
        max_features=g.max_features, num_down_blocks=g.num_down_blocks,
        num_bottleneck_blocks=g.num_bottleneck_blocks, skips=g.skips,
        num_regions=cfg.num_regions, revert_axis_swap=cfg.revert_axis_swap,
        pixelwise_flow_params=pf, dtype=dtype,
    ).eval()


def build_lfae_modules(cfg: LFAEConfig):
    """`(region_predictor, bg_predictor, generator)` in eval mode, on the
    CPU, with fp32 parameters; `cfg.compute_dtype` is the conv compute dtype."""
    dtype = _DTYPES[cfg.compute_dtype]
    rp, bp = cfg.region_predictor, cfg.bg_predictor
    region = RegionPredictor(
        num_regions=cfg.num_regions, num_channels=cfg.num_channels,
        block_expansion=rp.block_expansion, max_features=rp.max_features,
        num_blocks=rp.num_blocks, temperature=rp.temperature, scale_factor=rp.scale_factor,
        pca_based=rp.pca_based, estimate_affine=rp.estimate_affine, pad=rp.pad, dtype=dtype,
    )
    bg = BGMotionPredictor(
        num_channels=cfg.num_channels, block_expansion=bp.block_expansion,
        max_features=bp.max_features, num_blocks=bp.num_blocks, bg_type=bp.bg_type, dtype=dtype,
    )
    return region.eval(), bg.eval(), build_generator(cfg)


def seed_lfae_weights(modules, seed: int) -> None:
    """Fill the conv and dense kernels of the given modules in place from
    `numpy.random.RandomState(seed)`, N(0, 1/fan_in), in `named_parameters`
    order. Heads that start at the identity transform (`fc`, `jacobian`:
    zero kernel, identity bias), biases and BatchNorm values keep their
    constructed values. The counterpart of a random `init_lfae_vars` for runs
    without stage-1 weights; the values do not depend on the torch version."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for module in modules:
            for name, p in module.named_parameters():
                leaf = name.split(".")
                if p.ndim < 2 or leaf[-1] != "weight" or leaf[-2] in ("fc", "jacobian"):
                    continue
                fan_in = int(np.prod(p.shape[1:]))
                vals = rng.standard_normal(tuple(p.shape)).astype(np.float32) / np.sqrt(fan_in)
                p.copy_(torch.from_numpy(vals))

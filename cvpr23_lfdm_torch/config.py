"""Typed configuration for the PyTorch port.

A copy of `cvpr23_lfdm_tpu/config.py` (the port imports nothing of the JAX
package), so both packages read the same presets. Knobs that only steer
JAX code paths (`warp_impl`, `warp_tiled_max_res`, `sampler_unroll`) are
kept for a field-for-field match and are ignored by the port: its decode
warp is one exact kernel at every scale. `temporal_attn_impl` keeps the JAX
names: `"pallas3"` is the UNet's forward-only serving form (fused layers),
`"pallas2"` its differentiable training form (head-packed kernel pair); any
other value, the default `"xla"` included, lets the entry point choose
(serving `pallas3`, training `pallas2`; `models/unet3d.py::resolve_attn_impl`).

Replaces the reference's three stacked config mechanisms — YAML model
configs (config/mug128.yaml), argparse path/seed flags, and
"postfix"-string flag encoding (DM/train_video_flow_diffusion_mug.py:28-42)
— with plain dataclasses. Per-dataset presets mirror the reference's
published hyperparameters exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class RegionPredictorConfig:
    """config/mug128.yaml:63-79."""

    num_regions: int = 10
    block_expansion: int = 32
    max_features: int = 1024
    num_blocks: int = 5
    temperature: float = 0.1
    scale_factor: float = 0.25
    pca_based: bool = True
    # estimate_affine=True, pca_based=False selects the FOMM regression
    # branch (region_predictor.py:44-49); all shipped configs use PCA
    estimate_affine: bool = True
    # reference fast_svd (external CUDA batched SVD, region_predictor.py:16-19)
    # is a no-op here: the on-device closed-form 2x2 eig replaces both paths
    fast_svd: bool = False
    pad: int = 3  # 3 for MUG; 0 for MHAD/NATOPS (config diff)


@dataclass(frozen=True)
class BGPredictorConfig:
    """config/mug128.yaml:52-60."""

    block_expansion: int = 32
    max_features: int = 1024
    num_blocks: int = 5
    bg_type: str = "affine"


@dataclass(frozen=True)
class PixelwiseFlowConfig:
    """config/mug128.yaml:95-111."""

    block_expansion: int = 64
    max_features: int = 1024
    num_blocks: int = 5
    scale_factor: float = 0.25
    use_deformed_source: bool = True
    use_covar_heatmap: bool = True
    estimate_occlusion_map: bool = True
    region_var: float = 0.01


@dataclass(frozen=True)
class GeneratorConfig:
    """config/mug128.yaml:82-93."""

    block_expansion: int = 64
    max_features: int = 512
    num_down_blocks: int = 2
    num_bottleneck_blocks: int = 6
    skips: bool = True
    pixelwise_flow: PixelwiseFlowConfig = field(default_factory=PixelwiseFlowConfig)


@dataclass(frozen=True)
class LFAEConfig:
    """Stage-1 model bundle (config/mug128.yaml model_params)."""

    num_channels: int = 3
    num_regions: int = 10
    revert_axis_swap: bool = True
    frame_shape: int = 128
    # stage-1 conv compute dtype ("bfloat16" for the serving decode)
    compute_dtype: str = "float32"
    # JAX-only decode warp knobs (see module docstring)
    warp_impl: str = "xla"
    warp_tiled_max_res: int = 0
    region_predictor: RegionPredictorConfig = field(default_factory=RegionPredictorConfig)
    bg_predictor: BGPredictorConfig = field(default_factory=BGPredictorConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)


@dataclass(frozen=True)
class LFAETrainConfig:
    """config/mug128.yaml:121-154."""

    max_epochs: int = 100
    num_repeats: int = 100
    epoch_milestones: tuple[int, ...] = (60, 90)
    lr: float = 2.0e-4
    batch_size: int = 100
    use_sync_bn: bool = False
    scales: tuple[float, ...] = (1.0, 0.5, 0.25, 0.125)
    sigma_affine: float = 0.05
    sigma_tps: float = 0.005
    points_tps: int = 5
    perceptual_weights: tuple[float, ...] = (10, 10, 10, 10, 10)
    equivariance_shift_weight: float = 10.0
    equivariance_affine_weight: float = 10.0
    print_freq: int = 10
    save_img_freq: int = 100
    update_ckpt_freq: int = 5000


@dataclass(frozen=True)
class DiffusionConfig:
    """DM/modules/video_flow_diffusion_model.py:17-84 + train-script constants."""

    img_size: int = 32  # latent flow resolution (input 128 / 4)
    num_frames: int = 40
    timesteps: int = 1000
    sampling_timesteps: int = 1000  # < timesteps switches to DDIM
    ddim_sampling_eta: float = 1.0
    null_cond_prob: float = 0.1
    loss_type: str = "l2"
    use_dynamic_thres: bool = True
    dynamic_thres_percentile: float = 0.9
    # denoiser output parameterization: "eps" (reference,
    # video_flow_diffusion.py:697-701) | "x0" | "v" — same serving FLOPs;
    # see GaussianDiffusion.objective for when non-eps converges faster
    objective: str = "eps"
    # UNet
    dim: int = 64
    dim_mults: tuple[int, ...] = (1, 2, 4, 8)
    attn_heads: int = 8
    attn_dim_head: int = 32
    cond_dim: int = 768  # BERT embedding dim
    learn_null_cond: bool = False
    use_deconv: bool = True  # False -> nearest-upsample + conv ("upconv")
    use_final_activation: bool = False
    use_residual_flow: bool = False
    # mixed precision: UNet compute dtype (params/norms/softmax stay fp32)
    compute_dtype: str = "bfloat16"
    # "pallas3" | "pallas2" name a UNet form; anything else lets the entry
    # point choose (see module docstring)
    temporal_attn_impl: str = "xla"
    sampler_unroll: int = 1  # JAX-only knob


@dataclass(frozen=True)
class DMTrainConfig:
    """DM/train_video_flow_diffusion_*.py constants."""

    batch_size: int = 5
    max_epochs: int = 1200
    epoch_milestones: tuple[int, ...] = (800, 1000)
    lr: float = 2.0e-4
    adam_betas: tuple[float, float] = (0.9, 0.99)
    only_use_flow: bool = True
    frame_sampling: str = "very_random"  # uniform | random | very_random
    print_freq: int = 10
    save_img_freq: int = 200
    update_ckpt_freq: int = 2000
    save_vid_freq: int = 200
    sample_vid_freq: int = 1000


@dataclass(frozen=True)
class ExperimentConfig:
    dataset: str = "mug"  # mug | mhad | natops
    data_root: str = ""
    seed: int = 1234
    lfae: LFAEConfig = field(default_factory=LFAEConfig)
    lfae_train: LFAETrainConfig = field(default_factory=LFAETrainConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    dm_train: DMTrainConfig = field(default_factory=DMTrainConfig)
    # parallelism
    num_data_devices: int = 1

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def mug_config(**overrides) -> ExperimentConfig:
    """MUG preset (config/mug128.yaml + DM/train_video_flow_diffusion_mug.py)."""
    return ExperimentConfig(dataset="mug").replace(**overrides)


def mhad_config(**overrides) -> ExperimentConfig:
    """MHAD preset: region pad 0; DM bs 6, 1300 epochs, milestones [1000, 1150]."""
    cfg = ExperimentConfig(
        dataset="mhad",
        lfae=LFAEConfig(region_predictor=RegionPredictorConfig(pad=0)),
        dm_train=DMTrainConfig(batch_size=6, max_epochs=1300, epoch_milestones=(1000, 1150)),
    )
    return cfg.replace(**overrides)


def natops_config(**overrides) -> ExperimentConfig:
    """NATOPS preset: region pad 0; DM bs 20, 140 epochs, milestones [100, 120];
    learned null cond + upconv upsampling (train_..._natops.py postfix flags)."""
    cfg = ExperimentConfig(
        dataset="natops",
        lfae=LFAEConfig(region_predictor=RegionPredictorConfig(pad=0)),
        diffusion=DiffusionConfig(learn_null_cond=True, use_deconv=False),
        dm_train=DMTrainConfig(batch_size=20, max_epochs=140, epoch_milestones=(100, 120)),
    )
    return cfg.replace(**overrides)


PRESETS = {"mug": mug_config, "mhad": mhad_config, "natops": natops_config}

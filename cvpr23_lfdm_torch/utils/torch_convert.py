"""The reference's PyTorch checkpoints -> the port's modules (counterpart of
`cvpr23_lfdm_tpu/utils/torch_convert.py`).

The released LFAE (`RegionMM.pth`) and DM (`flowdiff.pth`) checkpoints are
PyTorch state dicts already; the port names its parameters after the JAX
package's variable paths, in torch layouts. So the conversion is a key map,
driven by the target module's own state dict: every port key has exactly one
reference key (`_lfae_source`, `_unet_source`) and a layout rule:

* `copy`: the same tensor (Conv2d OIHW, Linear `[out, in]`, BatchNorm and
  GroupNorm `weight` / `bias` / `running_*`, the relative-position
  `Embedding`);
* `squeeze`: a (1, k, k) Conv3d `[O, I, 1, k, k]` or ConvTranspose3d `[I, O,
  1, k, k]` as its 2-D module (the JAX package flips the deconv kernel into a
  dilated-conv HWIO form and `from_jax_params` flips it back: no flip here);
* `linear3d` / `linear2d`: a 1x1x1 Conv3d / 1x1 Conv2d as a `Linear`;
* `gamma` / `row`: the UNet LayerNorm's `[1, C, 1, 1, 1]` gamma and the
  `[1, D]` null-condition embedding, flattened;
* the reference's 7x7 init conv over latent + feature channels splits by
  linearity into `init_conv` (the latent channels, with the bias) and the
  bias-free `init_conv_fea`, as in the JAX package.

Reference keys the port has no use for (`num_batches_tracked`, rotary
frequencies, the diffusion schedule buffers) are not read. A missing
reference key raises `KeyError`; a shape that disagrees raises `ValueError`.
:func:`lfae_to_reference` and :func:`unet_to_reference` are the inverses:
the port's state dicts in the reference's layout.
"""

from __future__ import annotations

import re

import torch

_FORWARD = {
    "copy": lambda w: w,
    "squeeze": lambda w: w[:, :, 0],
    "linear3d": lambda w: w[:, :, 0, 0, 0],
    "linear2d": lambda w: w[:, :, 0, 0],
    "gamma": lambda w: w.reshape(-1),
    "row": lambda w: w.reshape(-1),
}
_INVERSE = {
    "copy": lambda w: w,
    "squeeze": lambda w: w[:, :, None],
    "linear3d": lambda w: w[:, :, None, None, None],
    "linear2d": lambda w: w[:, :, None, None],
    "gamma": lambda w: w.reshape(1, -1, 1, 1, 1),
    "row": lambda w: w.reshape(1, -1),
}
LFAE_PARTS = ("region_predictor", "bg_predictor", "generator")


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32)


# ------------------------------------------------------------------ LFAE


def _lfae_source(key: str) -> str:
    """The reference key (inside its module's state dict) of a port key of
    `RegionPredictor`, `BGMotionPredictor` or `Generator`: hourglass
    `down_{i}` / `up_{i}` and generator `down_blocks_{i}` / `up_blocks_{i}`
    are `ModuleList` entries there, `bottleneck_r{i}` a `Sequential` child."""
    key = re.sub(r"(^|\.)(down|up)_(?:blocks_)?(\d+)\.", r"\1\2_blocks.\3.", key)
    return re.sub(r"(^|\.)bottleneck_r(\d+)\.", r"\1bottleneck.r\2.", key)


def _lfae_shapes(cfg) -> dict[str, torch.Size]:
    from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE

    with torch.device("meta"):
        return {k: v.shape for k, v in FlowAE(cfg).state_dict().items()}


def convert_lfae_checkpoint(ckpt: dict, cfg) -> dict[str, torch.Tensor]:
    """A stage-1 checkpoint dict (LFAE/train.py:134-142 layout: the
    `generator`, `region_predictor` and `bg_predictor` state dicts; tensors
    or numpy arrays) -> a state dict of `FlowAE(cfg)`."""
    out = {}
    for key, shape in _lfae_shapes(cfg).items():
        part, _, rest = key.partition(".")
        value = _tensor(ckpt[part][_lfae_source(rest)])
        if value.shape != shape:
            raise ValueError(f"{part}.{_lfae_source(rest)}: shape {tuple(value.shape)}, "
                             f"the port's {key} is {tuple(shape)}")
        out[key] = value.clone()
    return out


def lfae_to_reference(state: dict) -> dict[str, dict[str, torch.Tensor]]:
    """A `FlowAE` state dict -> `{"generator"|"region_predictor"|
    "bg_predictor": reference state dict}`."""
    out = {part: {} for part in LFAE_PARTS}
    for key, value in state.items():
        part, _, rest = key.partition(".")
        out[part][_lfae_source(rest)] = _tensor(value).clone()
    return out


# ------------------------------------------------------------------ Unet3D


def _resnet_source(rest: str) -> tuple[str, str]:
    """`ResnetBlock` leaves: `mlp` is `Sequential(SiLU, Linear)`, a block's
    `proj` a (1,3,3) Conv3d, `res_conv` a 1x1x1 Conv3d."""
    parts = rest.split(".")
    if parts[0] == "mlp":
        return f"mlp.1.{parts[1]}", "copy"
    if parts[0] in ("block1", "block2") and parts[1] == "proj":
        return f"{parts[0]}.proj.{parts[3]}", "squeeze"
    if parts[0] == "res_conv":
        return rest, "linear3d"
    return rest, "copy"


def _attn_source(rest: str, kind: str) -> tuple[str, str]:
    """`Residual(PreNorm(dim, attn))`: the temporal and the mid spatial
    attention sit one wrapper deeper (`EinopsToAndFrom`) and hold Linear
    projections; the level's spatial linear attention holds 1x1 Conv2d."""
    if rest == "norm.gamma":
        return "fn.norm.gamma", "gamma"
    name = rest.removeprefix("attn.")
    if kind == "linear":
        return f"fn.fn.{name}", "linear2d"
    return f"fn.fn.fn.{name}", "copy"


_LEVEL_PARTS = {"block1": "0", "block2": "1", "spatial_attn": "2", "temporal_attn": "3"}
_TOP = {"mid_block1": "mid_block1", "mid_block2": "mid_block2", "final_block": "final_conv.0",
        "occlusion_block": "occlusion_map.0"}


def _unet_source(key: str) -> tuple[str, str]:
    """(reference key, layout rule) of a port `Unet3D` key; a bias is
    always `copy`."""
    src, rule = _unet_source_of_module(key)
    if rule not in ("gamma", "row") and not key.endswith(".weight"):
        rule = "copy"
    return src, rule


def _unet_source_of_module(key: str) -> tuple[str, str]:
    head, _, rest = key.partition(".")
    leaf = rest.split(".")[-1]
    m = re.fullmatch(r"(downs|ups)_(\d+)_(\w+)", head)
    if m:
        level, i, part = m.groups()
        base = f"{level}.{i}"
        if part in ("block1", "block2"):
            src, rule = _resnet_source(rest)
        elif part == "spatial_attn":
            src, rule = _attn_source(rest, "linear")
        elif part == "temporal_attn":
            src, rule = _attn_source(rest, "temporal")
        elif part == "downsample" or (part == "upsample" and rest.startswith("conv.")):
            # a (1,4,4) stride-2 Conv3d; without deconv, Sequential(Upsample, Conv3d)
            return f"{base}.4{'.1' if part == 'upsample' else ''}.{leaf}", "squeeze"
        elif part == "upsample":  # ConvTranspose3d (1,4,4)
            return f"{base}.4.{leaf}", "squeeze"
        else:
            raise KeyError(f"no reference key for {key}")
        return f"{base}.{_LEVEL_PARTS[part]}.{src}", rule
    if head in _TOP:
        src, rule = _resnet_source(rest)
        return f"{_TOP[head]}.{src}", rule
    if head in ("init_temporal_attn", "mid_temporal_attn", "mid_spatial_attn"):
        src, rule = _attn_source(rest, "temporal")
        return f"{head}.{src}", rule
    if head in ("final_conv", "occlusion_conv"):
        return f"{'final_conv' if head == 'final_conv' else 'occlusion_map'}.1.{leaf}", "linear3d"
    if head == "time_mlp_1":
        return f"time_mlp.1.{rest}", "copy"
    if head == "time_mlp_2":
        return f"time_mlp.3.{rest}", "copy"
    if key == "init_conv.conv.bias":  # the weight splits (`convert_unet3d`)
        return "init_conv.bias", "copy"
    if head == "time_rel_pos_bias":
        return key, "copy"
    if head == "null_cond_emb":
        return key, "row"
    raise KeyError(f"no reference key for {key}")


def convert_unet3d(sd: dict, unet, latent_channels: int = 3) -> dict[str, torch.Tensor]:
    """DM/modules/video_flow_diffusion.py `Unet3D` state dict (without the
    `denoise_fn.` prefix; tensors or numpy arrays) -> a state dict of `unet`
    (the port's `Unet3D` of the same config; its shapes are read, so a
    module on the `meta` device will do)."""
    out = {}
    for key, target in unet.state_dict().items():
        if key in ("init_conv.conv.weight", "init_conv_fea.conv.weight"):
            w = _tensor(sd["init_conv.weight"])[:, :, 0]
            value = w[:, :latent_channels] if key.startswith("init_conv.") else w[:, latent_channels:]
        else:
            src, rule = _unet_source(key)
            value = _FORWARD[rule](_tensor(sd[src]))
        if value.shape != target.shape:
            raise ValueError(f"{key}: the reference gives {tuple(value.shape)}, "
                             f"the port holds {tuple(target.shape)}")
        out[key] = value.contiguous().clone()
    return out


def unet_to_reference(state: dict) -> dict[str, torch.Tensor]:
    """A port `Unet3D` state dict -> the reference's layout (the inverse of
    :func:`convert_unet3d`)."""
    out = {}
    for key, value in state.items():
        value = _tensor(value)
        if key == "init_conv_fea.conv.weight":
            continue
        if key == "init_conv.conv.weight":
            fea = _tensor(state["init_conv_fea.conv.weight"])
            out["init_conv.weight"] = torch.cat([value, fea], dim=1)[:, :, None].clone()
            continue
        src, rule = _unet_source(key)
        out[src] = _INVERSE[rule](value).contiguous().clone()
    return out

"""A configuration file's `experiment` as the program's typed config, in the
form a driver runs it."""

from __future__ import annotations

import copy

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def merge(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def experiment(cell_config: dict, overrides: dict) -> dict:
    """The plain dict of the configuration as this run runs it (tests shrink
    it through `overrides["experiment"]`)."""
    return merge(cell_config["experiment"], overrides.get("experiment", {}))


def traffic(ctx, keys: set) -> dict:
    """The cell's traffic mix with the tests' overrides, refused where it
    names a key that the driver does not read."""
    t = {**ctx.cell.traffic, **ctx.overrides.get("traffic", {})}
    unread = set(t) - keys - {"kind"}
    if unread:
        raise ValueError(f"traffic keys {sorted(unread)} are not read by the {t['kind']!r} driver")
    return t


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def program_config(exp: dict, form: dict):
    """The program's `ExperimentConfig` of `exp`, with a form's compute
    dtypes, UNet form and sampler steps applied."""
    from cvpr23_lfdm_torch import config as C

    a = dict(exp["lfae"])
    g = dict(a.pop("generator"))
    g["pixelwise_flow"] = C.PixelwiseFlowConfig(**g["pixelwise_flow"])
    lfae = C.LFAEConfig(region_predictor=C.RegionPredictorConfig(**a.pop("region_predictor")),
                        bg_predictor=C.BGPredictorConfig(**a.pop("bg_predictor")),
                        generator=C.GeneratorConfig(**g), **a)
    diffusion = C.DiffusionConfig(**_tuples(exp["diffusion"]))
    if "lfae_dtype" in form:
        lfae = C.LFAEConfig(**{**lfae.__dict__, "compute_dtype": form["lfae_dtype"]})
    d = {}
    if "unet_dtype" in form:
        d["compute_dtype"] = form["unet_dtype"]
    if "temporal_attn_impl" in form:
        d["temporal_attn_impl"] = form["temporal_attn_impl"]
    if "sampling_timesteps" in form:
        d["sampling_timesteps"] = form["sampling_timesteps"]
        d["ddim_sampling_eta"] = form["ddim_sampling_eta"]
    diffusion = C.DiffusionConfig(**{**diffusion.__dict__, **d})
    rest = {k: v for k, v in exp.items() if k not in ("lfae", "diffusion", "lfae_train", "dm_train")}
    return C.ExperimentConfig(lfae=lfae, diffusion=diffusion,
                              lfae_train=C.LFAETrainConfig(**_tuples(exp["lfae_train"])),
                              dm_train=C.DMTrainConfig(**_tuples(exp["dm_train"])), **rest)


def set_tf32(form: dict) -> None:
    """TF32 for matmuls and cuDNN as the form states (both off in every
    form here: the fp32 parts run in fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(form.get("allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(form.get("allow_tf32", False))

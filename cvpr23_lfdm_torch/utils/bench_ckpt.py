"""The benchmark checkpoint, and the bridge from JAX variable trees.

Counterpart of `cvpr23_lfdm_tpu/utils/bench_ckpt.py::load_bench_ckpt`.
`assets/bench_ckpt/` holds the full UNet variables (`unet.msgpack`), the
LFAE generator subtree (`generator.msgpack`, without the training-only
pixelwise flow predictor), both stored fp16 and read back as fp32, a
conditioning vector (`cond.npy`), an in-distribution reference frame
(`ref.npy`) and `meta.json`, whose `objective` configures the sampler. Its
`tiled_*` keys tune the JAX package's TPU warp and are ignored here.

:func:`from_jax_params` turns a JAX variable tree (nested dicts of numpy
arrays, collections `params` and optionally `batch_stats`) into a state
dict of the port's modules, whose parameters are named after the tree
paths (`/` becomes `.`). Leaves map as:

* a conv `kernel` `[kh, kw, in, out]` (HWIO) -> `weight` OIHW;
* a deconv `Upsample` kernel K (`*_upsample.kernel`) -> a
  `ConvTranspose2d` weight `W[i, o, a, b] = K[3-a, 3-b, i, o]`;
* a Dense `kernel` `[in, out]`, or a 1x1x1 conv kernel `[1, 1, 1, in,
  out]` -> a `Linear` weight `[out, in]`;
* BatchNorm/GroupNorm `scale` -> `weight`; `mean`/`var` ->
  `running_mean`/`running_var`; an `Embed` `embedding` -> `weight`;
  `bias` and `gamma` keep their names.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from cvpr23_lfdm_torch.utils.msgpack import msgpack_restore

_RENAME = {
    "scale": "weight", "mean": "running_mean", "var": "running_var",
    "embedding": "weight",
}


def _convert_leaf(path: list[str], value: np.ndarray) -> tuple[str, np.ndarray]:
    name = path[-1]
    a = np.array(value, dtype=np.float32)  # a writable copy
    if name == "kernel":
        if a.ndim == 4 and path[-2].endswith("upsample"):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 5 and a.shape[:3] == (1, 1, 1):
            a = a.reshape(a.shape[3:]).T
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"unexpected kernel shape {a.shape} at {'/'.join(path)}")
        name = "weight"
    else:
        name = _RENAME.get(name, name)
    return ".".join(path[:-1] + [name]), np.ascontiguousarray(a)


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """State dict (fp32 tensors) of the port's module for a JAX variable
    tree `{"params": ..., "batch_stats": ...}` of the same module."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                key, arr = _convert_leaf(path + [k], v)
                if key in out:
                    raise ValueError(f"duplicate parameter {key}")
                out[key] = torch.from_numpy(arr)

    for col in ("params", "batch_stats"):
        if col in tree:
            walk(tree[col], [])
    return out


def lfae_subtree(lfae_vars: dict, name: str, with_flow_predictor: bool = True) -> dict:
    """One submodule's variables (`region_predictor`, `bg_predictor` or
    `generator`) out of a full LFAE tree `{"params"|"batch_stats": {...}}`;
    the generator optionally without its pixelwise flow predictor (as the
    serving model holds it and the bench checkpoint stores it)."""
    drop = () if with_flow_predictor else ("pixelwise_flow_predictor",)
    return {
        col: {k: v for k, v in lfae_vars[col][name].items() if k not in drop}
        for col in ("params", "batch_stats") if col in lfae_vars
    }


@dataclasses.dataclass
class BenchCkpt:
    unet_vars: dict  # {"params": ...} numpy fp32
    generator_vars: dict  # {"params": ..., "batch_stats": ...} numpy fp32
    cond: np.ndarray  # [cond_dim]
    ref: np.ndarray | None  # [H, W, 3] in [0, 1]
    meta: dict  # {"objective": ...}


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())

    def to_f32(node):
        if isinstance(node, dict):
            return {k: to_f32(v) for k, v in node.items()}
        return np.asarray(node, dtype=np.float32)

    return to_f32(tree)


def load_bench_ckpt(directory: str) -> BenchCkpt:
    """Read the checkpoint files (fp16 weights cast to fp32)."""
    paths = {n: os.path.join(directory, n) for n in ("unet.msgpack", "generator.msgpack", "cond.npy")}
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"bench checkpoint incomplete: {missing}")
    gen = _read(paths["generator.msgpack"])
    ref_path = os.path.join(directory, "ref.npy")
    meta = {"objective": "eps"}
    meta_path = os.path.join(directory, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    return BenchCkpt(
        unet_vars=_read(paths["unet.msgpack"]),
        generator_vars={col: gen[col]["generator"] for col in ("params", "batch_stats")},
        cond=np.load(paths["cond.npy"]).astype(np.float32),
        ref=np.load(ref_path).astype(np.float32) if os.path.exists(ref_path) else None,
        meta=meta,
    )


def apply_bench_ckpt(directory: str, cfg, device=None, training: bool = False,
                     lfae_seed: int = 0):
    """Build the model on the checkpoint: the sampler takes the
    checkpoint's `objective`. With `training`, the model is the training
    form; the checkpoint holds no region, background or pixelwise flow
    predictor, so those get seeded weights (`seed_lfae_weights(lfae_seed)`).
    Returns `(cfg, model, cond [1, D], ref [1, H, W, 3] or None, meta)`,
    tensors on the model's device (the CUDA card unless `device` says
    otherwise)."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights

    ck = load_bench_ckpt(directory)
    cfg = cfg.replace(
        diffusion=dataclasses.replace(cfg.diffusion, objective=ck.meta["objective"])
    )
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=training)
    model.unet.load_state_dict(from_jax_params(ck.unet_vars))
    state = from_jax_params(ck.generator_vars)
    if training:
        flow = model.generator.pixelwise_flow_predictor
        seed_lfae_weights([model.region_predictor, model.bg_predictor, flow], lfae_seed)
        state.update({f"pixelwise_flow_predictor.{k}": v for k, v in flow.state_dict().items()})
    model.generator.load_state_dict(state)
    cond = torch.from_numpy(ck.cond)[None].to(model.device)
    ref = None if ck.ref is None else torch.from_numpy(ck.ref)[None].to(model.device)
    return cfg, model, cond, ref, ck.meta

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

That covers every leaf of the UNet, the whole LFAE tree (`FlowAE` and
`LFAEReconstruction`: `params` and `batch_stats` of `region_predictor`,
`bg_predictor` and `generator`), `AVDNetwork` (Dense and BatchNorm leaves)
and `Vgg19Features` (`conv_{idx}`). :func:`to_jax_params` is the inverse: a
state dict of any of them -> a JAX variable tree of numpy arrays, so that a
JAX run can start from the port's weights. A state dict does not say which
`[out, in]` weights were 1x1x1 convolutions or embeddings; the UNet's are
named (`_CONV1X1X1`, `_EMBED`).

:func:`save_bench_ckpt` writes the checkpoint from the port's state dicts
(counterpart of the JAX `save_bench_ckpt`): the same files, the same bytes
for the same weights, through :func:`to_jax_params` and
`utils/msgpack.py::msgpack_serialize`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import io
import json
import os

import numpy as np
import torch

from cvpr23_lfdm_torch.utils.msgpack import msgpack_restore, msgpack_serialize

_RENAME = {
    "scale": "weight", "mean": "running_mean", "var": "running_var",
    "embedding": "weight",
}
# the UNet's modules whose JAX kernel is a 1x1x1 convolution `[1, 1, 1, in,
# out]` and whose `Embed` table is an `embedding`: the port holds both as
# `[out, in]` / `[num, dim]` weights, like a Dense layer's
_CONV1X1X1 = ("res_conv", "final_conv", "occlusion_conv")
_EMBED = ("relative_attention_bias",)


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


def to_jax_params(state: dict) -> dict:
    """The JAX variable tree `{"params": ..., "batch_stats": ...}` (nested
    dicts of fp32 numpy arrays) of a state dict of the UNet, the LFAE, the
    AVD network or the VGG, inverting :func:`from_jax_params`: `weight` OIHW
    -> conv `kernel` HWIO (a `*upsample` module's `ConvTranspose2d` weight ->
    its deconv kernel), `weight` `[out, in]` -> Dense `kernel` `[in, out]`
    (`_CONV1X1X1`: `[1, 1, 1, in, out]`; `_EMBED`: `embedding` as it is), a
    1-D `weight` -> `scale`, `running_mean` / `running_var` -> `batch_stats`
    `mean` / `var`; `bias` and `gamma` keep their names."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        path = key.split(".")
        a = value.detach().cpu().numpy().astype(np.float32) if torch.is_tensor(value) else (
            np.asarray(value, np.float32))
        col, name = "params", path[-1]
        owner = path[-2] if len(path) > 1 else ""
        if name in ("running_mean", "running_var"):
            col, name = "batch_stats", name.removeprefix("running_")
        elif name == "weight":
            if a.ndim == 4 and owner.endswith("upsample"):
                a, name = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif a.ndim == 4:
                a, name = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 2 and owner in _EMBED:
                name = "embedding"
            elif a.ndim == 2 and owner in _CONV1X1X1:
                a, name = a.T.reshape((1, 1, 1) + a.T.shape), "kernel"
            elif a.ndim == 2:
                a, name = a.T, "kernel"
            elif a.ndim == 1:
                name = "scale"
            else:
                raise ValueError(f"unexpected weight shape {a.shape} at {key}")
        elif name not in ("bias", "gamma"):
            raise ValueError(f"no JAX leaf for {key}")
        node = tree[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return {col: sub for col, sub in tree.items() if sub}


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


# --------------------------------------------------------------- the writer

_UNET, _GEN, _COND, _REF, _META = "unet.msgpack", "generator.msgpack", "cond.npy", "ref.npy", "meta.json"


@contextlib.contextmanager
def _writer_lock(directory: str):
    """Exclusive advisory lock on `<directory>/.lock`: a second writer raises
    instead of interleaving its weights with the first one's."""
    os.makedirs(directory, exist_ok=True)
    fd = os.open(os.path.join(directory, ".lock"), os.O_CREAT | os.O_RDWR)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            holder = os.pread(fd, 64, 0).decode(errors="replace").strip() or "?"
            raise RuntimeError(f"bench-ckpt writer lock held (pid {holder}) for {directory}; "
                               f"stop the other writer first") from e
        os.ftruncate(fd, 0)
        os.pwrite(fd, str(os.getpid()).encode(), 0)
        yield
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """Write to a temporary file, then rename it into place: a reader never
    sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fp16(tree: dict) -> dict:
    return {k: _fp16(v) if isinstance(v, dict) else np.asarray(v).astype(np.float16) for k, v in tree.items()}


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr.detach().cpu() if torch.is_tensor(arr) else arr, np.float32))
    return buf.getvalue()


def save_bench_ckpt(directory: str, unet_state: dict, lfae_state: dict, cond, ref=None,
                    meta: dict | None = None) -> None:
    """Write a bench checkpoint from the port's weights: `unet.msgpack` (the
    UNet's state dict, in full), `generator.msgpack` (the generator of a
    `FlowAE` state dict, without its pixelwise flow predictor, which serving
    never applies), both float16 through :func:`to_jax_params`; `cond.npy`,
    and `ref.npy` and `meta.json` when given. Every file is written
    atomically under an exclusive writer lock. `load_bench_ckpt` of either
    package reads it."""
    lfae = to_jax_params(lfae_state)
    gen = {col: {"generator": lfae_subtree(lfae, "generator", with_flow_predictor=False)[col]}
           for col in ("params", "batch_stats")}
    with _writer_lock(directory):
        _atomic_write(os.path.join(directory, _UNET), msgpack_serialize(_fp16(to_jax_params(unet_state))))
        _atomic_write(os.path.join(directory, _GEN), msgpack_serialize(_fp16(gen)))
        _atomic_write(os.path.join(directory, _COND), _npy(cond))
        if ref is not None:
            _atomic_write(os.path.join(directory, _REF), _npy(ref))
        if meta is not None:
            _atomic_write(os.path.join(directory, _META), json.dumps(meta, indent=1).encode())

"""Data-parallel serving of the sampling pipeline, and the demo's bundled
inputs (counterpart of `cvpr23_lfdm_tpu/parallel/serving.py`).

`--mesh dp=N` (the CLIs `demo` and `test_dm`): N processes, one per
device, each holding the weights; the request batch is padded to a
multiple of N and each rank samples its contiguous rows through the normal
`FlowDiffusion.sample_video` (so the kernels run on every rank as in a
one-process run), then the outputs are gathered on every rank. The
gaussians are drawn at the padded global batch's shape from the same
generator on every rank, and each rank keeps its rows: the video equals
the one-process video of the padded batch up to the order of sums inside
a rank's smaller batch.

`--mesh dp=N,tp=M` adds the `model` axis: N * M processes, the UNet of
each in its tensor-parallel form (`models/unet3d.py::shard_unet`: a
rank's heads and channels, the fused layers in their head-shard mode),
the LFAE replicated as in the JAX package. `sp=K` adds the `space` axis:
the LFAE's encoder and decoder of each rank in band mode
(`models/generator.py::shard_generator`: its band of the image's rows,
halo exchanges between neighbouring bands, each warp source gathered and
the band's rows warped by row 3), the UNet whole on the gathered feature,
the sampled latent broadcast from the first space rank before the decode.
Any of the three combine (N * M * K processes, `data` x `model` x
`space`). The model and space ranks of a data index sample the same rows
with the same draws; rows are gathered over the `data` axis only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cvpr23_lfdm_torch.diffusion.gaussian_diffusion import _normal
from cvpr23_lfdm_torch.parallel.distributed import process_count
from cvpr23_lfdm_torch.models.generator import check_sp, shard_generator
from cvpr23_lfdm_torch.models.unet3d import check_tp, shard_unet
from cvpr23_lfdm_torch.parallel.mesh import all_gather_rows, local_rows, make_mesh

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def demo_asset_path(dataset: str) -> str:
    """Bundled reference image for the argument-free demo (the reference
    ships demo/mug_examples/*.png; ours are synthetic, assets/demo/)."""
    return os.path.join(_REPO_ROOT, "assets", "demo", f"{dataset}_example.png")


def make_demo_assets(out_dir: str, size: int = 128, seed: int = 0) -> list[str]:
    """Write one synthetic example image per dataset (demo default inputs),
    as PNG through `data/io.py::write_png`."""
    from cvpr23_lfdm_torch.data.io import write_png
    from cvpr23_lfdm_torch.data.synthetic import _blob_video

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    colors = {"mug": (0.9, 0.6, 0.4), "mhad": (0.4, 0.7, 0.9), "natops": (0.5, 0.9, 0.5)}
    for ds, color in colors.items():
        frame = _blob_video(np.random.default_rng(seed), 1, size, color)[0]
        path = os.path.join(out_dir, f"{ds}_example.png")
        write_png(path, frame.astype(np.uint8))
        paths.append(path)
    return paths


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse a `--mesh` CLI value like `"dp=8"` or `"dp=4,tp=2"` into an
    ordered {axis: size} dict. Empty string -> {} (single device)."""
    out: dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("dp", "tp", "sp"):
            raise ValueError(f"unknown mesh axis {k!r} in --mesh {spec!r}")
        out[k] = int(v)
    return out


def serving_mesh(spec: str, device=None, frame_shape: int | None = None, num_down_blocks: int = 2):
    """The mesh of a `--mesh` spec (None for an empty one): `dp=N` alone the
    `data` mesh; with `tp=M` or `sp=K` above 1 the `data` x `model`,
    `data` x `space` or `data` x `model` x `space` mesh. `N * M * K` must
    be the number of processes, since a mesh member is a process here; M
    must divide the UNet's 8 GroupNorm groups (`check_tp`), and with the
    frames' height `frame_shape` K must cut it into whole even bands
    (`check_sp`, which the generator checks on its input too)."""
    axes = parse_mesh_spec(spec)
    if not axes:
        return None
    dp, tp, sp, world = axes.get("dp", 1), axes.get("tp", 1), axes.get("sp", 1), process_count()
    check_tp(tp)
    if frame_shape is not None:
        check_sp(sp, frame_shape, num_down_blocks)
    if dp * tp * sp != world:
        what = f"dp={dp}" + (f" x tp={tp}" if tp > 1 else "") + (f" x sp={sp}" if sp > 1 else "")
        raise ValueError(f"--mesh {spec!r}: {what} needs {dp * tp * sp} processes, one per device "
                         f"(--num-processes or torchrun); this run has {world}")
    if tp == sp == 1:
        return make_mesh(dp, device=device)
    names, shape = ("data",), (dp,)
    for name, n in (("model", tp), ("space", sp)):
        if n > 1:
            names, shape = names + (name,), shape + (n,)
    return make_mesh(shape, names, device=device)


class LocalDraws:
    """`draws[i]`: the i-th gaussian of the global `shape` drawn from
    `generator`, this rank's rows of it. The samplers read their per-step
    noise `noise_seq[i]` once each, in order, which is the order in which a
    one-process sampler draws it; the draws are made as they are read, so
    the whole sequence is never held."""

    def __init__(self, shape, generator, device, mesh):
        self.shape, self.generator, self.device, self.mesh = tuple(shape), generator, device, mesh
        self._next = 0

    def __getitem__(self, i: int) -> torch.Tensor:
        if i != self._next:
            raise IndexError(f"draw {i} read out of order (next is {self._next})")
        self._next += 1
        return local_rows(_normal(self.shape, self.generator, self.device), self.mesh)


def _pad_rows(x: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """`x` with its last row along `dim` repeated up to `rows` rows."""
    pad = rows - x.shape[dim]
    if pad <= 0:
        return x
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([x, last.expand(*(pad if d == dim else -1 for d in range(x.ndim)))], dim)


def sample_video_sharded(model, mesh, ref_imgs, conds, cond_scale: float = 1.0,
                         generator: torch.Generator | None = None, init_img=None,
                         noise_seq=None) -> dict:
    """Data-parallel `FlowDiffusion.sample_video` over `mesh` (with a
    `model` axis, the UNet sharded first by `shard_unet`; with a `space`
    axis, the generator put in band mode first by `shard_generator`);
    every rank calls it with the same global request batch.

    `ref_imgs [B, H, W, 3]` and `conds [B, cond_dim]` are padded (the last
    row repeated) to a multiple of the mesh's size; this rank samples its
    rows, and every output is gathered and stripped of the pad rows.
    `generator` (the same seed on every rank) draws `init_img` and the
    per-step noise at the padded batch's shape; `init_img [B, F, h, w, 3]`
    and `noise_seq [steps, B, F, h, w, 3]` inject them (the padded batch's
    rows, or the request's, padded as above)."""
    shard_unet(model.unet, mesh)
    shard_generator(model.generator, mesh)
    b = ref_imgs.shape[0]
    rows = b + (-b) % mesh.size
    d = model.cfg
    shape = (rows, d.num_frames, d.img_size, d.img_size, 3)
    if init_img is None:
        init_img = _normal(shape, generator, model.device)
    init_img = local_rows(_pad_rows(init_img, rows), mesh)
    if noise_seq is None:
        noise_seq = LocalDraws(shape, generator, model.device, mesh)
    else:
        noise_seq = local_rows(_pad_rows(noise_seq, rows, dim=1), mesh, dim=1)
    out = model.sample_video(local_rows(_pad_rows(ref_imgs, rows), mesh),
                             local_rows(_pad_rows(conds, rows), mesh), cond_scale,
                             init_img=init_img, noise_seq=noise_seq)
    return {k: all_gather_rows(v, mesh)[:b] for k, v in out.items()}

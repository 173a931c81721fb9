"""Bilinear backward warps: one source per video at per-frame grids, and
one source per grid fused with an occlusion blend.

Counterpart of `cvpr23_lfdm_tpu/ops/warp.py::grid_sample` (the plain
version) and of the Pallas kernel `cvpr23_lfdm_tpu/ops/warp_pallas.py::
warp_video_tiled` (`csrc/warp_blend.cu`). Semantics are those of
`torch.nn.functional.grid_sample`, bilinear, grid last axis `(x, y)` in
[-1, 1], in channel-last layout; the kernels take `align_corners=False`,
`padding_mode='zeros'`, which is all the model's warps use.

:func:`grid_sample` is the plain, differentiable version, and also takes the
`border` and `reflection` padding modes and `align_corners` (the TPS warp of
LFAE training samples with reflection padding). Its gradient is autograd's
through the same arithmetic, which equals the JAX package's hand-written
VJP (`_grid_sample_bwd`): the image's is a scatter of the four weighted
corners, the grid's the bilinear weights' derivative chained through the
coordinate transform, with JAX's gradients at the clip and reflection ties
(`ops/ties.py`). :func:`train_warp` is the differentiable warp of the
LFAE training path (:func:`torch.nn.functional.grid_sample`, zeros padding,
on a channel-last view); see its docstring for why it is that one.

The CUDA kernels. The TPU kernel samples through a one-hot matmul over a
window of the source around each output tile, and a fit check sends any
tile whose corners leave the window to a gather fallback. On the H100 a
warp is bound by bytes: the four corners of each output are read from
the shared `[B, H, W, C]` source (which stays in the 50 MB L2 at every
decode scale) and the output `[B, F, H, W, C]` is written once.
:func:`warp_video` launches the one warp core of the port,
`csrc/warp_blend.cu`, with a frame axis (output image i samples source
image i / F) and in the source's dtype: fp32 weights and sums, the sum
rounded once to bf16 or kept in fp32, every step rounded as the plain
version rounds it, so that the two agree bit for bit. It is exact for
every flow, so it has no windows, tiles or fit check, and the generator
uses it at every decode scale.

:func:`warp_onehot` and :func:`warp_gather` are the counterparts of the
Pallas kernels of the same names in `warp_pallas.py`: one source per grid,
fused with a blend (none, `* occ`, `* occ + prev * (1 - occ)`), everything
cast to fp32 and an fp32 result. On the TPU they are two formulations of
one function (a dense one-hot `[HW, HW]` matrix product, which caps `H*W`
at 1024 to fit VMEM, and a lane gather without a cap); on the H100 both
names launch one kernel, `csrc/warp_blend.cu`, and neither has a size cap.
So the JAX package's `tiled_max_res` / `MAX_HW` limits have no counterpart
here. That kernel works out each output pixel's four corners (32-bit
offsets inside its image, weights, `csrc/bilinear.cuh`) once, by one
thread of a block that owns 256 consecutive pixels, then streams the
tile's pixels x channels outputs with all its threads (16-byte units
where C fills them: `C % 4 == 0` in fp32, `C % 8 == 0` in bf16), the blend
in its epilogue; it rounds every step as the plain version does. One
image may hold at most 2^31 - 1 elements.
:func:`warp_blend_plain` is their plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvpr23_lfdm_torch.ops import _build, ties


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    span = hi - lo
    t = torch.remainder(x - lo, 2.0 * span)
    return span - ties.abs_(t - span) + lo


def _resolve_coords(coord: torch.Tensor, size: int, align_corners: bool,
                    padding_mode: str) -> torch.Tensor:
    """Unnormalized coordinate after the padding mode's transform (before
    the floor)."""
    ix = _unnormalize(coord, size, align_corners)
    if padding_mode == "reflection":
        ix = _reflect(ix, 0.0, float(size - 1)) if align_corners else _reflect(ix, -0.5, size - 0.5)
        ix = ties.clip(ix, 0.0, float(size - 1))
    elif padding_mode == "border":
        ix = ties.clip(ix, 0.0, float(size - 1))
    return ix


def grid_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Plain bilinear sample of `image [B, H, W, C]` at `grid [B, Hg, Wg, 2]`
    -> `[B, Hg, Wg, C]`; `padding_mode` is `zeros`, `border` or `reflection`.
    Weights and the sum are fp32; the result has the image's dtype."""
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: unknown padding_mode {padding_mode!r}")
    b, h, w, c = image.shape
    gh, gw = grid.shape[1], grid.shape[2]
    g = grid.float().reshape(b, gh * gw, 2)
    ix = _resolve_coords(g[..., 0], w, align_corners, padding_mode)
    iy = _resolve_coords(g[..., 1], h, align_corners, padding_mode)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx1 = ix - x0
    wy1 = iy - y0
    x0 = x0.to(torch.long)
    y0 = y0.to(torch.long)
    flat = image.reshape(b, h * w, c)
    out = torch.zeros(b, gh * gw, c, dtype=torch.float32, device=image.device)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
            vals = torch.gather(flat, 1, idx[..., None].expand(b, gh * gw, c))
            out += vals.float() * (wy * wx * valid)[..., None]
    return out.to(image.dtype).reshape(b, gh, gw, c)


def train_warp(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The differentiable warp of the LFAE training path (the generator's
    decode scales and the pixelwise flow predictor's deformed source, as the
    JAX package warps with its XLA `grid_sample` whenever `train` is set):
    `image [B, H, W, C]` at `grid [B, Hg, Wg, 2]`, zeros padding,
    `align_corners=False`, fp32. It is one `F.grid_sample` call (one forward
    and one backward kernel) on an NCHW view of the channel-last image: the
    same function as :func:`grid_sample`, which launches a gather and a few
    elementwise kernels per corner forward and a scatter per corner
    backward, and took twice as long over the warps of a B=100 MUG step on
    an H100 (`scripts/bench_train_warp.py`, `PERF.md`). Its backward, like
    the plain version's, adds with atomics on a CUDA tensor, so a training
    step is not bit-reproducible there."""
    out = F.grid_sample(image.float().permute(0, 3, 1, 2), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def warp_video_plain(src: torch.Tensor, grid5: torch.Tensor) -> torch.Tensor:
    """`src [B, Hs, W, C]` sampled at `grid5 [B, F, Ho, W, 2]` -> `[B, F, Ho, W, C]`,
    without repeating the source. The grid's normalised coordinates address
    the whole source, whatever its own height `Ho`: a band of output rows
    (`Ho < Hs`, the decode of one band of a `space` mesh) is those rows of
    the whole-height warp."""
    b, f, h, w, _ = grid5.shape
    out = grid_sample(src, grid5.reshape(b, f * h, w, 2))
    return out.reshape(b, f, h, w, src.shape[-1])


_MAX_IMAGE = 2 ** 31 - 1  # elements of one [H, W, C] image: the warp core's 32-bit offsets
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong


def warp_video(src: torch.Tensor, grid5: torch.Tensor) -> torch.Tensor:
    """Warp of one source per video `src [B, Hs, W, C]` at per-frame grids
    `grid5 [B, F, Ho, W, 2]` -> `[B, F, Ho, W, C]`, `Ho <= Hs`: the whole
    frames (`Ho == Hs`), or a band of output rows whose grid addresses the
    whole source (:func:`warp_video_plain`). CPU tensors take the plain
    version; CUDA tensors launch the warp core of `csrc/warp_blend.cu`
    with a frame axis, which is forward-only (a gradient goes through
    :func:`grid_sample`). One source image, and one output image, may hold
    at most 2^31 - 1 elements. A call with `Ho < Hs` also counts in
    `warp_video.band_launches`."""
    if src.device.type == "cpu":
        return warp_video_plain(src, grid5)
    if src.device.type != "cuda":
        raise RuntimeError(f"warp_video: unsupported device {src.device}")
    b, f, ho, w, two = grid5.shape
    h, c = src.shape[1], src.shape[-1]
    if two != 2 or src.ndim != 4 or tuple(src.shape) != (b, h, w, c) or not 1 <= ho <= h:
        raise ValueError(f"warp_video: shapes {tuple(src.shape)} {tuple(grid5.shape)}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"warp_video: source dtype {src.dtype}")
    if grid5.dtype != torch.float32:
        raise TypeError(f"warp_video: grid dtype {grid5.dtype} (want float32)")
    if grid5.device != src.device:
        raise ValueError("warp_video: source and grid on different devices")
    if not (src.is_contiguous() and grid5.is_contiguous()):
        raise ValueError("warp_video: inputs must be contiguous")
    if h * w * c > _MAX_IMAGE:
        raise ValueError(f"warp_video: one image holds {h * w * c} elements, more than "
                         f"the kernel's 32-bit offsets reach ({_MAX_IMAGE})")
    _build.require_no_grad("warp_video", src, grid5)
    out = torch.empty((b, f, ho, w, c), dtype=src.dtype, device=src.device)
    fn = _build.bind("warp_blend", "launch_warp_video", [ctypes.c_int] + [_PTR] * 3 + [_LL] * 6 + [_PTR])
    code = fn(int(src.dtype == torch.bfloat16), _build.ptr(src), _build.ptr(grid5), _build.ptr(out),
              b, f, h, ho, w, c, _build.stream(src.device))
    _build.check(_build.load("warp_blend"), "launch_warp_video", code)
    warp_video.launches += 1
    warp_video.band_launches += ho < h
    return out


_BLENDS = {"none": 0, "occlusion": 1, "previous": 2}


def _blend_mode(occlusion, previous, blend):
    if blend is None:
        blend = "previous" if previous is not None else (
            "occlusion" if occlusion is not None else "none")
    if blend not in _BLENDS:
        raise ValueError(f"warp: blend {blend!r} not in {tuple(_BLENDS)}")
    if (blend != "none" and occlusion is None) or (blend == "previous" and previous is None):
        raise ValueError(f"warp: blend {blend!r} without its occlusion or previous tensor")
    return blend


def warp_blend_plain(image, grid, occlusion=None, previous=None, blend=None):
    """Plain version of :func:`warp_onehot` / :func:`warp_gather` (same
    arguments): :func:`grid_sample` on fp32 casts, then the blend; fp32."""
    blend = _blend_mode(occlusion, previous, blend)
    warped = grid_sample(image.float(), grid.float())
    if blend == "none":
        return warped
    occ = occlusion.float()
    if blend == "occlusion":
        return warped * occ
    return warped * occ + previous.float() * (1.0 - occ)


def _warp_blend(wrapper, image, grid, occlusion, previous, blend):
    name = wrapper.__name__
    if image.device.type == "cpu":
        return warp_blend_plain(image, grid, occlusion, previous, blend)
    if image.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {image.device}")
    blend = _blend_mode(occlusion, previous, blend)
    if image.ndim != 4:
        raise ValueError(f"{name}: image must be [B, H, W, C], got {tuple(image.shape)}")
    b, h, w, c = image.shape
    used = {"image": (image, (b, h, w, c)), "grid": (grid, (b, h, w, 2))}
    if blend != "none":
        used["occlusion"] = (occlusion, (b, h, w, 1))
    if blend == "previous":
        used["previous"] = (previous, (b, h, w, c))
    for key, (t, shape) in used.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
        if t.device != image.device:
            raise ValueError(f"{name}: arguments on different devices")
        if not t.is_floating_point():
            raise TypeError(f"{name}: {key} dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: arguments must be contiguous")
    if h * w * c > _MAX_IMAGE:
        raise ValueError(f"{name}: one image holds {h * w * c} elements, more than "
                         f"the kernel's 32-bit offsets reach ({_MAX_IMAGE})")
    _build.require_no_grad(name, *(t for t, _ in used.values()))
    f32 = {key: t.float() for key, (t, _) in used.items()}  # as the TPU wrappers cast
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=image.device)
    fn = _build.bind("warp_blend", "launch_warp_blend_f32", [_PTR] * 5 + [_LL] * 4 + [ctypes.c_int, _PTR])
    null = ctypes.c_void_p(None)
    ptr = lambda key: _build.ptr(f32[key]) if key in f32 else null
    code = fn(ptr("image"), ptr("grid"), ptr("occlusion"), ptr("previous"), _build.ptr(out),
              b, h, w, c, _BLENDS[blend], _build.stream(image.device))
    _build.check(_build.load("warp_blend"), "launch_warp_blend_f32", code)
    wrapper.launches += 1
    return out


def warp_onehot(image, grid, occlusion=None, previous=None, blend=None):
    """Bilinear warp fused with an optional occlusion blend.

    Args:
      image: `[B, H, W, C]` source features.
      grid: `[B, H, W, 2]` backward warp grid, (x, y) in [-1, 1]; the output
        resolution equals the input's.
      occlusion: optional `[B, H, W, 1]`; previous: optional `[B, H, W, C]`
        blend partner (`warped * occ + previous * (1 - occ)`).
      blend: `"none"`, `"occlusion"` or `"previous"`; inferred when None.

    Returns `[B, H, W, C]` fp32. CPU tensors take the plain version; CUDA
    tensors launch `csrc/warp_blend.cu` (forward-only) or raise. No cap on
    `H*W`, unlike the TPU kernel of this name; one image may hold at most
    2^31 - 1 elements (`H*W*C`).
    """
    return _warp_blend(warp_onehot, image, grid, occlusion, previous, blend)


def warp_gather(image, grid, occlusion=None, previous=None, blend=None):
    """Same function and same kernel as :func:`warp_onehot` (two
    formulations on the TPU, one on the H100); counted on its own."""
    return _warp_blend(warp_gather, image, grid, occlusion, previous, blend)


warp_video.launches = 0
warp_video.band_launches = 0
warp_onehot.launches = 0
warp_gather.launches = 0

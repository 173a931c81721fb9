"""Bilinear backward warp of one source per video at per-frame grids.

Counterpart of `cvpr23_lfdm_tpu/ops/warp.py::grid_sample` (the plain
version) and of the Pallas kernel `cvpr23_lfdm_tpu/ops/warp_pallas.py::
warp_video_tiled` (`csrc/warp_video.cu`). Semantics are those of
`torch.nn.functional.grid_sample` with `align_corners=False`,
`padding_mode='zeros'`, bilinear, grid last axis `(x, y)` in [-1, 1], in
channel-last layout.

The CUDA kernel. The TPU kernel samples through a one-hot matmul over a
window of the source around each output tile, and a fit check sends any
tile whose corners leave the window to a gather fallback. On the H100 a
warp is bound by bytes: the four corners of each output are read from
the shared `[B, H, W, C]` source (which stays in the 50 MB L2 at every
decode scale) and the output `[B, F, H, W, C]` is written once. So the
kernel gives one thread to each output element, with neighbouring threads
on neighbouring channels of one pixel (coalesced corner reads and output
writes); out-of-image corners weigh zero; it accumulates in fp32 and
writes the source's dtype. It is exact for every flow, so it has no
windows, tiles or fit check, and the generator uses it at every decode
scale.
"""

from __future__ import annotations

import ctypes

import torch

from cvpr23_lfdm_torch.ops import _build


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain bilinear sample of `image [B, H, W, C]` at `grid [B, Hg, Wg, 2]`
    -> `[B, Hg, Wg, C]`. Weights and the sum are fp32; the result has the
    image's dtype."""
    b, h, w, c = image.shape
    gh, gw = grid.shape[1], grid.shape[2]
    g = grid.float().reshape(b, gh * gw, 2)
    ix = _unnormalize(g[..., 0], w)
    iy = _unnormalize(g[..., 1], h)
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


def warp_video_plain(src: torch.Tensor, grid5: torch.Tensor) -> torch.Tensor:
    """`src [B, H, W, C]` sampled at `grid5 [B, F, H, W, 2]` -> `[B, F, H, W, C]`,
    without repeating the source."""
    b, f, h, w, _ = grid5.shape
    out = grid_sample(src, grid5.reshape(b, f * h, w, 2))
    return out.reshape(b, f, h, w, src.shape[-1])


def warp_video(src: torch.Tensor, grid5: torch.Tensor) -> torch.Tensor:
    """Warp of one source per video at per-frame grids, `[B, F, H, W, C]`.
    CPU tensors take the plain version; CUDA tensors launch
    `csrc/warp_video.cu`, which is forward-only (a gradient goes through
    :func:`grid_sample`)."""
    if src.device.type == "cpu":
        return warp_video_plain(src, grid5)
    if src.device.type != "cuda":
        raise RuntimeError(f"warp_video: unsupported device {src.device}")
    b, f, h, w, two = grid5.shape
    c = src.shape[-1]
    if two != 2 or tuple(src.shape) != (b, h, w, c):
        raise ValueError(f"warp_video: shapes {tuple(src.shape)} {tuple(grid5.shape)}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"warp_video: source dtype {src.dtype}")
    if grid5.dtype != torch.float32:
        raise TypeError(f"warp_video: grid dtype {grid5.dtype} (want float32)")
    if grid5.device != src.device:
        raise ValueError("warp_video: source and grid on different devices")
    if not (src.is_contiguous() and grid5.is_contiguous()):
        raise ValueError("warp_video: inputs must be contiguous")
    _build.require_no_grad("warp_video", src, grid5)
    out = torch.empty((b, f, h, w, c), dtype=src.dtype, device=src.device)
    lib = _build.load("warp_video")
    name = "launch_warp_video_" + ("f32" if src.dtype == torch.float32 else "bf16")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
    code = fn(
        _build.ptr(src), _build.ptr(grid5), _build.ptr(out),
        b, f, h, w, c, _build.stream(src.device),
    )
    _build.check(lib, name, code)
    warp_video.launches += 1
    return out


warp_video.launches = 0

"""Fused GroupNorm + FiLM + SiLU of the UNet's `Block` (serving forward).

Counterpart of `cvpr23_lfdm_tpu/ops/norm_pallas.py`:
:func:`groupnorm_film_silu` replaces the Pallas `groupnorm_film_silu`
(`_kernel`): `silu(GroupNorm(x) * (scale + 1) + shift)` with fp32 statistics
per (batch, group) over (F, H, W, C/groups), `var = E[x²] − mean²`, the
affine parameters and the optional FiLM `[B, C]` folded into one multiply
and one add per channel, the result in x's dtype
(`csrc/groupnorm_film_silu.cu`). Forward-only, as in the JAX package: the
training form keeps the unfused `GroupNorm`.

On the H100 the function is bound by bytes (x read, y written). The TPU
kernel takes one grid step per batch entry with the whole activation in
VMEM; here the reduction is split over many blocks and finished in a second
pass: launch 1 writes per-chunk, per-group sums and sums of squares, launch
2 adds the chunks in index order, folds the per-channel multiply and add
and streams the elements. No atomics, so a repeated call returns the same
bits. The plain version repeats the kernel's arithmetic; it is the CPU path
and the yardstick on the card, never a fallback there.
"""

from __future__ import annotations

import ctypes

import torch

from cvpr23_lfdm_torch.ops import _build

_CHUNK_ELEMS = 16384  # elements of one block of the reduction launch
_MAX_CHANNELS = 2048  # the kernel's per-thread accumulators cover C <= 8 * 256


def groupnorm_film_silu_plain(x, gamma, beta, scale=None, shift=None,
                              groups: int = 8, eps: float = 1e-5):
    """Plain version of :func:`groupnorm_film_silu` (same arguments)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    n = xf.shape[1]
    cnt = float(n * (c // groups))
    s_g = xf.sum(dim=1).reshape(b, groups, c // groups).sum(dim=-1)
    ss_g = (xf * xf).sum(dim=1).reshape(b, groups, c // groups).sum(dim=-1)
    mean_g = s_g / cnt
    var_g = ss_g / cnt - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // groups, dim=1)  # [B, C]
    inv_c = inv_g.repeat_interleave(c // groups, dim=1)
    mul = inv_c * gamma.float()[None]
    add = beta.float()[None] - mean_c * mul
    if scale is not None:
        sc = scale.float().reshape(b, c) + 1.0
        mul = mul * sc
        add = add * sc + shift.float().reshape(b, c)
    y = xf * mul[:, None] + add[:, None]
    return (y * torch.sigmoid(y)).to(x.dtype).reshape(x.shape)


def groupnorm_film_silu(x, gamma, beta, scale=None, shift=None,
                        groups: int = 8, eps: float = 1e-5):
    """`silu(GroupNorm(x) * (scale + 1) + shift)`.

    Args:
      x: `[B, F, H, W, C]`, bf16 or fp32; gamma, beta: `[C]` GroupNorm
        affine parameters.
      scale, shift: optional `[B, C]` FiLM conditioning (broadcast over F,
        H, W), both or neither; read as fp32.

    Returns `[B, F, H, W, C]` in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch `csrc/groupnorm_film_silu.cu` or raise
    (also when a gradient is asked: the kernel is forward-only).
    """
    if x.device.type == "cpu":
        return groupnorm_film_silu_plain(x, gamma, beta, scale, shift, groups, eps)
    name = "groupnorm_film_silu"
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype} (want float32 or bfloat16)")
    if x.ndim != 5:
        raise ValueError(f"{name}: x must be [B, F, H, W, C], got {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    if c % groups or c > _MAX_CHANNELS:
        raise ValueError(f"{name}: C={c} with {groups} groups (C <= {_MAX_CHANNELS})")
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: scale and shift come together")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"{name}: gamma/beta shapes {tuple(gamma.shape)} {tuple(beta.shape)}")
    film = ()
    if scale is not None:
        if scale.numel() != b * c or shift.numel() != b * c:
            raise ValueError(f"{name}: scale/shift must hold [B, C] = {(b, c)} values")
        film = (scale, shift)
    _build.require_no_grad(name, x, gamma, beta, *film)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if any(t.device != x.device for t in (gamma, beta, *film)):
        raise ValueError(f"{name}: arguments on different devices")
    # the small per-channel tables go in as fp32, as the TPU wrapper casts them
    gamma, beta, *film = (t.float().contiguous() for t in (gamma, beta, *film))
    chunks = max(1, min(1024, -(-n * c // _CHUNK_ELEMS)))
    partial = torch.empty((b, chunks, groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load("groupnorm_film_silu")
    fname = "launch_groupnorm_film_silu_" + ("f32" if x.dtype == torch.float32 else "bf16")
    fn = getattr(lib, fname)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    code = fn(_build.ptr(x), _build.ptr(gamma), _build.ptr(beta),
              _build.ptr(film[0]) if film else null, _build.ptr(film[1]) if film else null,
              _build.ptr(partial), _build.ptr(out), b, n, c, groups, chunks, eps,
              _build.stream(x.device))
    _build.check(lib, fname, code)
    groupnorm_film_silu.launches += 1
    return out


groupnorm_film_silu.launches = 0

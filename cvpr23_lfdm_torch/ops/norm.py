"""Fused conv bias + GroupNorm + FiLM + SiLU of the UNet's `Block` (serving
forward).

Counterpart of `cvpr23_lfdm_tpu/ops/norm_pallas.py`:
:func:`groupnorm_film_silu` replaces the Pallas `groupnorm_film_silu`
(`_kernel`): `silu(GroupNorm(x) * (scale + 1) + shift)` with fp32 statistics
per (batch, group) over (F, H, W, C/groups), `var = max(E[x²] − mean², 0)`
(clamped as flax's GroupNorm), the affine parameters and the optional FiLM
`[B, C]` folded into one multiply and one add per channel, the result in x's
dtype (`csrc/groupnorm_film_silu.cu`). An optional `pre_bias [C]` is the
conv bias that a bf16 `Block` adds after its rounded product
(`models/blocks.py::split_bias`): the function then normalises
`round(x + pre_bias)` in x's dtype, which is that add. Forward-only, as in
the JAX package: the training form keeps the unfused `GroupNorm`.

On the H100 the function is bound by bytes (x read, y written). The TPU
kernel takes one grid step per batch entry with the whole activation in
VMEM; here one cooperative launch spreads each batch entry over many
blocks, all resident at once: each block holds its chunk of rows in shared
memory (as much as fits; the rest is read again), sums it, meets the other
blocks at a grid barrier, adds its batch entry's partial sums in a fixed
order and streams the result from the chunk it holds. No atomics, so a
repeated call returns the same bits; one launch per call, with no cast or
copy of the per-channel tables (read in their own dtype and strides).
:func:`norm_plan` sizes the grid. The plain version repeats the kernel's
arithmetic; it is the CPU path and the yardstick on the card, never a
fallback there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cvpr23_lfdm_torch.ops import _build

_MAX_CHANNELS = 2048   # a thread owns at most four columns of the scalar path: C <= 4 * 512
_THREADS = 512         # threads of a block (the kernel's kNormThreads)
_SMEM = 115712         # the most dynamic shared memory of a block (kNormSmem)
_MIN_ELEMS = 8192      # elements a block takes at least, so that a small call uses few blocks


class NormPlan(NamedTuple):
    """The grid of one call: `vec` elements per load (16 bytes' worth, or 1
    on the scalar path), `blocks` per batch entry of `rows` rows (pixels of
    all frames) each, the first `hold_rows` of which a block holds in
    shared memory (the rest it reads twice), and `smem` bytes of dynamic
    shared memory a block."""
    vec: int
    blocks: int
    rows: int
    hold_rows: int
    smem: int


def norm_vec(c: int, groups: int, esz: int, ptr: int) -> int:
    """Elements per load: 16 bytes' worth where C and C / groups are whole
    vectors and x starts on 16 bytes, else 1 (the scalar path)."""
    v = 16 // esz
    return v if c % v == 0 and (c // groups) % v == 0 and ptr % 16 == 0 else 1


def _scratch(c: int, groups: int, vec: int) -> int:
    """Bytes of a block's scratch before its rows (the kernel's
    scratch_bytes): the four per-channel tables, column sums per row lane,
    then mean and rstd per group."""
    cv = c // vec
    red = (_THREADS // min(cv, _THREADS)) * cv
    return -(-4 * (2 * red + 2 * groups + 4 * c) // 16) * 16


@functools.lru_cache(maxsize=1024)
def norm_plan(b: int, n: int, c: int, groups: int, esz: int, vec: int, sms: int,
              blocks_per_sm: int) -> NormPlan:
    """Grid of a call on x `[b, n, c]` of `esz`-byte elements: each batch
    entry gets an equal share of the `sms * blocks_per_sm` blocks the card
    holds at once, or fewer where a block would take under `_MIN_ELEMS`
    elements; rows are split evenly, and a block holds as many of its rows
    as fit beside its scratch in `_SMEM` bytes."""
    total = sms * blocks_per_sm
    if b > total:
        raise ValueError(f"groupnorm_film_silu: batch {b} exceeds the {total} blocks the card holds at once")
    blocks = max(1, min(total // b, -(-n * c // _MIN_ELEMS)))
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    scratch = _scratch(c, groups, vec)
    hold = max(0, min(rows, (_SMEM - scratch) // (c * esz)))
    return NormPlan(vec, blocks, rows, hold, scratch + hold * c * esz)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_LAUNCH_ARGS = ([_INT] * 2 + [_PTR] * 7 + [_INT] + [_LL] * 7 + [_PTR]
                + [_INT, _LL, _INT, _INT, _INT, _LL, _LL, _INT, ctypes.c_float, _PTR])


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, bf16: bool, vec: bool) -> int:
    """Blocks of the (dtype, path) kernel one SM holds at `_SMEM` bytes."""
    fn = _build.bind("groupnorm_film_silu", "groupnorm_film_silu_blocks_per_sm", [_INT, _INT])
    with torch.cuda.device(index):
        n = fn(int(bf16), int(vec))
    if n < 1:
        raise RuntimeError(f"groupnorm_film_silu: no block fits on an SM (CUDA error {-n})")
    return n


_workspace: dict = {}


def _partials(device, stream: int, n: int) -> torch.Tensor:
    """The per-block partial sums: one buffer per (device, stream), reused by
    every call on that stream (calls on one stream run one after another)."""
    key = (device.index, stream)
    buf = _workspace.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 14), dtype=torch.float32, device=device)
        _workspace[key] = buf
    return buf


def groupnorm_film_silu_plain(x, gamma, beta, scale=None, shift=None,
                              groups: int = 8, eps: float = 1e-5, pre_bias=None):
    """Plain version of :func:`groupnorm_film_silu` (same arguments)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    if pre_bias is not None:  # the conv's bias add, rounded to x's dtype as it rounds
        xf = (xf + pre_bias.float()).to(x.dtype).float()
    n = xf.shape[1]
    cnt = float(n * (c // groups))
    s_g = xf.sum(dim=1).reshape(b, groups, c // groups).sum(dim=-1)
    ss_g = (xf * xf).sum(dim=1).reshape(b, groups, c // groups).sum(dim=-1)
    mean_g = s_g / cnt
    var_g = (ss_g / cnt - mean_g * mean_g).clamp_min(0.0)
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
                        groups: int = 8, eps: float = 1e-5, pre_bias=None):
    """`silu(GroupNorm(round(x + pre_bias)) * (scale + 1) + shift)`.

    Args:
      x: `[B, F, H, W, C]`, bf16 or fp32; gamma, beta: `[C]` GroupNorm
        affine parameters.
      scale, shift: optional FiLM conditioning of `B * C` values each
        (`[B, C]`, or the UNet's `[B, 1, 1, 1, C]` halves of one `[..., 2C]`
        tensor; broadcast over F, H, W), both or neither.
      pre_bias: optional `[C]` added to x first, the sum rounded to x's
        dtype (a bf16 conv's bias, added after its rounded product).
      The tables may be fp32 or bf16 at any strides; the kernel reads them
      as they are.

    Returns `[B, F, H, W, C]` in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch `csrc/groupnorm_film_silu.cu` or raise
    (also when a gradient is asked: the kernel is forward-only).
    """
    if x.device.type == "cpu":
        return groupnorm_film_silu_plain(x, gamma, beta, scale, shift, groups, eps, pre_bias)
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
    pre = () if pre_bias is None else (pre_bias,)
    if any(tuple(t.shape) != (c,) for t in (gamma, beta, *pre)):
        raise ValueError(f"{name}: gamma/beta/pre_bias shapes {[tuple(t.shape) for t in (gamma, beta, *pre)]}")
    film = ()
    if scale is not None:
        if scale.numel() != b * c or shift.numel() != b * c:
            raise ValueError(f"{name}: scale/shift must hold [B, C] = {(b, c)} values")
        film = (scale, shift)
    _build.require_no_grad(name, x, gamma, beta, *film, *pre)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if any(t.device != x.device for t in (gamma, beta, *film, *pre)):
        raise ValueError(f"{name}: arguments on different devices")
    bf16, esz, dev = x.dtype == torch.bfloat16, x.element_size(), x.device
    vec = norm_vec(c, groups, esz, x.data_ptr())
    plan = norm_plan(b, n, c, groups, esz, vec, _sm_count(dev.index),
                     _blocks_per_sm(dev.index, bf16, vec > 1))
    # the tables in their own dtype and strides: no cast or copy on the card. A FiLM
    # table laid out [B, ..., C] (the UNet's [B, 1, 1, 1, C] halves) is read at its
    # own (batch, channel) strides; any other layout of its B * C values as [B, C]
    film = tuple(t if t.shape[0] == b and t.shape[-1] == c else t.reshape(b, c) for t in film)
    kinds = 0
    for i, t in ((0, gamma), (1, beta), *zip((2, 3), film), *zip((4,), pre)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: gamma/beta/scale/shift/pre_bias must be float32 or bfloat16")
        kinds |= (t.dtype == torch.bfloat16) << i
    strides = [gamma.stride(0), beta.stride(0)]
    for t in film:
        strides += [t.stride(0), t.stride(-1)]
    strides += [0] * (6 - len(strides)) + [pre_bias.stride(0) if pre else 0]
    ptrs = [t.data_ptr() for t in (gamma, beta)]
    ptrs += [t.data_ptr() for t in film] if film else [None, None]
    ptrs += [pre_bias.data_ptr() if pre else None]
    out = torch.empty_like(x)
    stream = _build.stream(dev)
    partial = _partials(dev, stream.value, b * plan.blocks * groups * 2)
    fn = _build.bind("groupnorm_film_silu", "launch_groupnorm_film_silu", _LAUNCH_ARGS)
    code = fn(int(bf16), int(plan.vec > 1), x.data_ptr(), out.data_ptr(), *ptrs, kinds,
              *strides, partial.data_ptr(), b, n, c, groups, plan.blocks, plan.rows,
              plan.hold_rows, plan.smem, eps, stream)
    _build.check(_build.load("groupnorm_film_silu"), "launch_groupnorm_film_silu", code)
    groupnorm_film_silu.launches += 1
    return out


groupnorm_film_silu.launches = 0

"""The UNet's attention kernels: the two fused PreNorm layers of serving, the
differentiable head-packed temporal attention of training and the packed
temporal attention of the `pallas` form, each with its plain version.

Counterparts of `cvpr23_lfdm_tpu/ops/attention_pallas.py`:

* :func:`fused_temporal_layer` replaces the Pallas `fused_temporal_layer`
  (`_fused_layer_kernel`): `x + W_out·MHA(rotary(W_qkv·LN(x)))`, attention
  over the F frames of each pixel (`csrc/fused_temporal_layer.cu`).
* :func:`fused_spatial_linear_layer` replaces the Pallas
  `fused_spatial_linear_layer` (`_fused_linear_kernel`): per-frame linear
  attention `x + W_out·linattn(W_qkv·LN(x)) + b`
  (`csrc/fused_spatial_linear_layer.cu`).
* :func:`headpacked_temporal_attention` replaces the Pallas
  `headpacked_temporal_attention` (`_headpacked_kernel` and its custom-VJP
  backward `_headpacked_bwd_kernel`): rotary + softmax attention over the F
  frames on the raw `to_qkv` output, a `torch.autograd.Function` whose
  forward and backward are both kernels (`csrc/headpacked_attention.cu`).
* :func:`packed_temporal_attention` replaces the Pallas
  `packed_temporal_attention` (`_kernel`): softmax attention over the F
  frames on a `[B, HW, F, 3hd]` qkv whose rotary and q-scale were applied
  outside, under the additive bias of :func:`build_bias`
  (`csrc/packed_attention.cu`; forward-only, as in the JAX package).
* :func:`fused_temporal_layer_ablated` launches a timing-only build of
  `csrc/fused_temporal_layer.cu` with one stage removed (the counterpart of
  the ablated kernels of the JAX package's `scripts/bench_attn_ablate.py`).

The fused layers are forward-only (as in the JAX package): on a CUDA
tensor they raise when a gradient is asked of them.

Both fused layers take `x [B, F, HW, C]` in bf16 (serving) or fp32, the LN gamma in
fp32, and the projection weights in `x`'s dtype. The plain versions repeat
the Pallas kernels' arithmetic (fp32 LN statistics with var = E[x²]−mean²,
fp32 matmul accumulation, rounding to the compute dtype at the same
points); they are the CPU path and the yardstick of the kernels, never a
fallback on the card. Each wrapper counts its launches in `.launches`.

`fused_temporal_layer` on the H100. The layer is bound by operations:
about 7 GFLOP against 10 MB of activations at the 64-channel 32² level;
nothing but `x`, the weights and the output touches device memory. In bf16
(serving) it runs on tensor cores with the heads spread over a thread-block
cluster (:func:`temporal_layer_plan`): the K blocks of a cluster share a
chunk of P pixels, each block `heads // K` heads (K = 1, no exchange, at
the two largest levels, 2 at the middle ones, 8, one head per block, at the
16-pixel ones; C a multiple of 16). A block copies its x rows
into a swizzled bf16 tile by 16-byte `cp.async` and LayerNorms them in
place; per head, the q|k|v projection on `mma.sync` (one warp per 16-row
query strip), rotary on the C fragments, the softmax attention over the
frames with `csrc/mma.cuh`'s strips (a max per head; `exp` rounded to bf16
for `p·v` and the denominator, `o` after the division, as the Pallas
kernel rounds) and the head's out-projection on `mma.sync` into the block's
fp32 partial in shared memory. The cluster then sums the partials through
distributed shared memory in rank order, each block its slice of the
columns, and adds the residual: no atomics, the same bits every run. fp32
keeps the CUDA-core kernel (P·C ≤ 256 pixels' rows per block, the heads
one after another, FMA products over shared memory): TF32 would not hold
the fp32 gates. The bias comes in as `bias_flat`, so focus rows are
`NEG_INF` off the diagonal as on the TPU.

`fused_spatial_linear_layer` on the H100. The k-softmax reduces over all
HW pixels of a frame, so the layer is a chain of two launches, the context
and then the output; the per-head 32×32 context `kᵀv` (not the TPU's masked
256×256 product) is the only intermediate in device memory. It is bound by
operations (the projections), like the temporal layer, and takes any HW.
In bf16 (serving) both launches run on tensor cores in thread-block
clusters (:func:`linear_layer_plan`, C a multiple of 16). The context
launch: a block owns a split of a frame's row tiles and a group of heads,
one warp per head; it LayerNorms each tile once for all its heads, projects
k|v on `mma.sync`, keeps an online softmax of k over the rows in the C
fragments and adds `pᵀv` on `mma.sync` (p and v rounded to bf16); the
splits of a frame, one cluster, merge their (max, sum, context) partials
in rank order through distributed shared memory. The output launch: the K
blocks of a cluster share a tile of rows, each with `heads // K` heads for
the q projection, q-softmax (the plain version's rounding points) and
`q·context`, all on `mma.sync`; the cluster gathers the heads' outputs
through distributed shared memory and each block runs the out-projection
of its slice of the columns, `+ b`, and the residual. No atomics, the same
bits every run. fp32 keeps the CUDA-core kernels (one block per frame and
head for the context, one per 32 pixels for the output, FMA products over
shared memory).

`headpacked_temporal_attention` on the H100 (`csrc/headpacked_attention.cu`,
replacing `_headpacked_kernel` and `_headpacked_bwd_kernel` of
`attention_pallas.py`). The pair is bound by bytes: the forward reads qkv
and writes the output, the backward reads qkv and `do` and writes `dqkv`
(0.42 / 0.73 GB at B=5, HW=1024 in bf16); the products, 4·F²·d and
10·F²·d FLOP per (pixel, head), are far below the tensor cores' rate per
byte. In bf16 (the training step) the products run on tensor cores:
`mma.sync` m16n8k16, bf16 operands, fp32 sums. A block owns a chunk of
pixels of one (batch, head) and keeps that head's rotary tables and
`[F, F]` bias in shared memory; each of its warps walks its pixels one at
a time, copies the pixel's q, k, v (and `do`) rows with 16-byte `cp.async`
into swizzled `[16·⌈F/16⌉, 32]` tiles (pad rows zero), rotates them in
place (the rotary partner is the neighbouring channel, so in the same
16-byte vector), and runs query strips of 16 rows: scores and `dP` by
`ldmatrix` fragments, the softmax in the C fragments (a max per head,
pad keys at −inf), the exponentials packed to bf16 as the A fragments of
`p·v`, `ds·k`, and, transposed in registers by `movmatrix`, of
`dk += dsᵀq` and `dv += pᵀdo`, whose sums stay in registers over the
strips. Outputs leave through a staging tile as 16-byte stores of whole
rows; the rotary adjoint is applied in registers, so `dqkv` is the
gradient of the raw qkv. Every operand is rounded to bf16 where the
plain version rounds (rotated qkv, `exp`, `prob`, `ds`; `dk`, `dv` before
the adjoint, `dq` not), so the tensor cores change only the order of the
fp32 sums. fp32 keeps the first design on CUDA cores (a block of four
warps per (pixel, head), fp32 rows in shared memory, FMA loops): `mma` on
fp32 would be TF32, which the fp32 gates would not pass. `dbias` sums over
all pixels: each warp (bf16) or block (fp32) adds `ds` into its own
`[F, F]` shared-memory tile, a block writes one partial per chunk (bf16:
its warps' tiles added in warp order), and a second launch adds the
chunks in index order. No atomics, so a step's gradients are the same bit
for bit from run to run.

`packed_temporal_attention` on the H100 (`csrc/packed_attention.cu`,
replacing `_kernel` of `attention_pallas.py`). Bound by bytes like the
head-packed forward. The TPU kernel packs P pixels into one `[P*F, d]`
tile and masks the cross-pixel scores with a `[P*F, P*F]` bias; the masked
entries are exactly 0 after `exp`, so the kernel reads only each pixel's
own `[F, F]` diagonal block of that bias and computes no cross-pixel
score. In bf16 (the `pallas` form) it is the head-packed forward's design
without the rotary: a block per (batch, head, pixel chunk) keeps the
diagonal bias blocks of its pixels in shared memory (block `x % P` for
pixel `x`, so a chunk may start anywhere), each warp walks its pixels one
(pixel, head) unit at a time, copies the unit's q, k, v rows by 16-byte
`cp.async` into swizzled tiles (pad rows zero) and runs `mma.sync` query
strips: scores, bias, the fp32 softmax in the C fragments, each row
scaled by the reciprocal of its sum and only then rounded to bf16 (the
Pallas rounding point) as the A fragments of `p·v`; outputs leave as
16-byte row stores.
:func:`_packed_chunks` sizes the chunks from the card's SM count. fp32
keeps a block of four warps per unit on CUDA cores (fp32 rows in shared
memory, FMA loops): TF32 would not hold the fp32 gates. The plain version
runs the packed tiles against the whole bias, as the TPU kernel does, so
the two are held together.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from cvpr23_lfdm_torch.ops import _build

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
_TINY = float(np.finfo(np.float32).tiny)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 232448  # dynamic shared memory of one block on the H100
_SMEM_PER_SM = 233472  # shared memory of one SM on the H100
_REGS = 160  # registers per thread of the bf16 temporal-layer kernel (ptxas: 125-159)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def rotary_tables(f: int, heads: int, dim_head: int, scale: float, dtype,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary + q-scale folded into full-width qkv tables `[F, 3*h*d]`:
    q columns get scale*cos/scale*sin, k columns cos/sin, v columns 1/0.
    Made once per arguments and kept on `device` (read only): a layer's
    call enqueues its work without waiting on an upload."""
    rot_dim = min(32, dim_head)
    freqs = 1.0 / (10000.0 ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    ang = np.repeat(np.outer(np.arange(f, dtype=np.float64), freqs), 2, -1)
    cos1 = np.ones((f, dim_head))
    sin1 = np.zeros((f, dim_head))
    cos1[:, :rot_dim] = np.cos(ang)
    sin1[:, :rot_dim] = np.sin(ang)
    cos_h = np.tile(cos1, (1, heads))
    sin_h = np.tile(sin1, (1, heads))
    cos_t = np.concatenate([scale * cos_h, cos_h, np.ones_like(cos_h)], axis=-1)
    sin_t = np.concatenate([scale * sin_h, sin_h, np.zeros_like(sin_h)], axis=-1)
    # round through fp32 as the JAX tables do before any cast to bf16
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
    return as_t(cos_t), as_t(sin_t)


def build_bias_flat(pos_bias: torch.Tensor, batch: int, f: int,
                    focus_present_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rel-pos bias (+ focus self-only rows) as `[B, F, heads*F]` fp32:
    `out[b, i, g*F + j] = pos_bias[g, i, j]` shifted so each (head, row)
    max is 0, or NEG_INF off the frame diagonal for focused entries."""
    heads = pos_bias.shape[0]
    pos_bias = pos_bias.float()
    # the shift is a softmax-invariant constant: no gradient through the max
    pos_bias = pos_bias - pos_bias.amax(dim=-1, keepdim=True).detach()
    flat = pos_bias.permute(1, 0, 2).reshape(f, heads * f)
    out = flat[None].expand(batch, f, heads * f)
    if focus_present_mask is not None:
        eye = torch.eye(f, dtype=torch.bool, device=flat.device).repeat(1, heads)
        self_only = torch.where(eye, flat, torch.full_like(flat, NEG_INF))
        out = torch.where(focus_present_mask[:, None, None], self_only[None], out)
    return out.contiguous()


def pick_pack(hw: int, f: int, target_rows: int = 256) -> int:
    """Largest power-of-2 P dividing hw with P*F <= target rows."""
    best = 1
    p = 1
    while p <= hw:
        if hw % p == 0 and p * f <= target_rows:
            best = p
        p *= 2
    return best


def build_bias(pos_bias: torch.Tensor, batch: int, pack: int, f: int,
               focus_present_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rel-pos bias + block-diagonal mask (+ focus self-only rows) as one
    additive `[B, heads, P*F, P*F]` fp32 tensor: the bias tiled over the PxP
    pixel grid, cross-pixel entries NEG_INF; focused batch entries keep only
    the frame diagonal. Unshifted (unlike :func:`build_bias_flat`)."""
    heads = pos_bias.shape[0]
    pf = pack * f
    dev = pos_bias.device
    block_mask = torch.kron(torch.eye(pack, device=dev), torch.ones(f, f, device=dev)) > 0
    tiled = pos_bias.float().repeat(1, pack, pack)  # [h, PF, PF]
    neg = torch.full_like(tiled, NEG_INF)
    base = torch.where(block_mask[None], tiled, neg)
    out = base[None].expand(batch, heads, pf, pf)
    if focus_present_mask is not None:
        self_mask = torch.eye(pf, dtype=torch.bool, device=dev)
        focused = torch.where(self_mask[None], tiled, neg)
        out = torch.where(focus_present_mask[:, None, None, None], focused[None], out)
    return out.contiguous()


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """Interleaved rotary partner: (x0, x1, ...) -> (-x1, x0, ...)."""
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def _layer_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Gamma-only channel LN, fp32 statistics, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * gamma.float()).to(x.dtype)


def fused_temporal_layer_plain(x, gamma, wqkv, wout, bias_flat, cos_t, sin_t,
                               heads: int, dim_head: int, eps: float = 1e-5, partial: bool = False):
    """Plain version of :func:`fused_temporal_layer` (same arguments)."""
    b, f, hw, c = x.shape
    dt = x.dtype
    hd = heads * dim_head
    xn = _layer_norm(x, gamma, eps)
    qkv = xn.float() @ wqkv.float()  # [B, F, HW, 3hd] fp32
    blk = (qkv * cos_t.float()[None, :, None] + rotate_pairs(qkv) * sin_t.float()[None, :, None]).to(dt)
    q, k, v = (blk[..., i * hd:(i + 1) * hd].reshape(b, f, hw, heads, dim_head).float()
               for i in range(3))
    s = torch.einsum("bixhd,bjxhd->bxhij", q, k)
    bias = bias_flat.float().reshape(b, f, heads, f).permute(0, 2, 1, 3)  # [B, h, i, j]
    s = s + bias[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    num = torch.einsum("bxhij,bjxhd->bixhd", e, v)
    den = e.sum(dim=-1).permute(0, 3, 1, 2)[..., None].clamp_min(_TINY)  # [B, i, x, h, 1]
    o = (num / den).to(dt).reshape(b, f, hw, hd)
    proj = o.float() @ wout.float()
    return proj if partial else x + proj.to(dt)


def fused_spatial_linear_layer_plain(x, gamma, wqkv, wout, bout,
                                     heads: int, dim_head: int, eps: float = 1e-5,
                                     partial: bool = False):
    """Plain version of :func:`fused_spatial_linear_layer` (same arguments)."""
    b, f, n, c = x.shape
    dt = x.dtype
    d = dim_head
    hd = heads * d
    xn = _layer_norm(x, gamma, eps)
    qkv = xn.float() @ wqkv.float()  # [B, F, N, 3hd] fp32
    q = qkv[..., :hd].reshape(b, f, n, heads, d)
    eq = torch.exp(q - q.amax(dim=-1, keepdim=True)).to(dt)
    den = eq.float().sum(dim=-1, keepdim=True).clamp_min(_TINY)
    qn = (eq.float() / den).to(dt) * (d ** -0.5)
    k = qkv[..., hd:2 * hd]
    ek = torch.exp(k - k.amax(dim=2, keepdim=True))
    kn = (ek / ek.sum(dim=2, keepdim=True)).to(dt).reshape(b, f, n, heads, d)
    v = qkv[..., 2 * hd:].to(dt).reshape(b, f, n, heads, d)
    ctx = torch.einsum("bfnhd,bfnhe->bfhde", kn.float(), v.float()).to(dt)
    out = torch.einsum("bfnhd,bfhde->bfnhe", qn.float(), ctx.float()).to(dt)
    proj = out.reshape(b, f, n, hd).float() @ wout.float()
    return proj if partial else x + (proj + bout.float()).to(dt)


def _check_layer_args(name, x, gamma, wqkv, wout, hd, same_dtype, f32):
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (want float32 or bfloat16)")
    c = x.shape[-1]
    want = {"gamma": (gamma, (c,)), "wqkv": (wqkv, (c, 3 * hd)), "wout": (wout, (hd, c))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
    for t in (x, gamma, wqkv, wout, *same_dtype, *f32):
        if t.device != x.device:
            raise ValueError(f"{name}: arguments on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: arguments must be contiguous")
    for t in (wqkv, wout, *same_dtype):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: weight dtype {t.dtype} != x dtype {x.dtype}")
    for t in (gamma, *f32):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype} where float32 is required")


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def fused_temporal_layer(x, gamma, wqkv, wout, bias_flat, cos_t, sin_t,
                         heads: int, dim_head: int, eps: float = 1e-5, partial: bool = False):
    """`x + to_out(attn(rotary(to_qkv(LN(x)))))` over the frame axis.

    Args:
      x: `[B, F, HW, C]` layer input (the residual source).
      gamma: `[C]` fp32 LN scale; wqkv: `[C, 3*heads*d]`; wout: `[heads*d, C]`.
      bias_flat: `[B, F, heads*F]` fp32 (:func:`build_bias_flat`).
      cos_t/sin_t: `[F, 3*heads*d]` (:func:`rotary_tables`).
      partial: the head-shard mode of tensor parallelism: `heads` are one
        rank's heads (its q|k|v columns of `wqkv`, rows of `wout`, slices of
        `bias_flat` and the tables) and the result is the fp32 `to_out`
        partial over them, with no residual and no rounding.

    Returns `[B, F, HW, C]` (fp32 with `partial`). The kernel needs d = 32
    and F <= 64. `.launches` counts every launch, `.partial_launches` those
    in the head-shard mode.
    """
    if x.device.type == "cpu":
        return fused_temporal_layer_plain(
            x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, heads, dim_head, eps, partial)
    out = _launch_fused_temporal_layer(
        (), x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, heads, dim_head, eps, partial)
    fused_temporal_layer.launches += 1
    fused_temporal_layer.partial_launches += int(partial)
    return out


def _launch_fused_temporal_layer(defines, x, gamma, wqkv, wout, bias_flat, cos_t, sin_t,
                                 heads, dim_head, eps, partial=False):
    """Check the arguments and launch `csrc/fused_temporal_layer.cu` as
    built under `defines` (none: the serving kernel)."""
    b, f, hw, c = x.shape
    hd = heads * dim_head
    _check_layer_args("fused_temporal_layer", x, gamma, wqkv, wout, hd,
                      (cos_t, sin_t), (bias_flat,))
    _build.require_no_grad("fused_temporal_layer", x, gamma, wqkv, wout, bias_flat)
    if dim_head != 32 or f > 64:
        raise ValueError(f"fused_temporal_layer: needs d=32, F<=64 (d={dim_head}, F={f})")
    if tuple(bias_flat.shape) != (b, f, heads * f) or tuple(cos_t.shape) != (f, 3 * hd) \
            or tuple(sin_t.shape) != (f, 3 * hd):
        raise ValueError("fused_temporal_layer: bias or rotary table shape")
    out = torch.empty_like(x, dtype=torch.float32 if partial else x.dtype)
    ints = (b, f, hw, c, heads)
    if x.dtype == torch.bfloat16:
        if c % 16:
            raise ValueError(f"fused_temporal_layer: the bf16 kernel needs C % 16 == 0 (C={c})")
        _check_aligned("fused_temporal_layer", x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, out)
        plan = temporal_layer_plan(b, f, hw, c, heads, _sm_count(x.device.index))
        ints += (plan["pixels"], plan["cluster"])
    name = "launch_fused_temporal_layer_" + _suffix(x.dtype)
    fn = _build.bind("fused_temporal_layer", name,
                     [_PTR] * 8 + [_INT] * (len(ints) + 1) + [ctypes.c_float, _PTR], defines)
    code = fn(
        *(_build.ptr(t) for t in (x, gamma, wqkv, wout, bias_flat, cos_t, sin_t, out)),
        *ints, int(partial), eps, _build.stream(x.device),
    )
    _build.check(_build.load("fused_temporal_layer", defines), name, code)
    return out


def temporal_layer_smem(f: int, c: int, pixels: int, heads_per_block: int) -> int:
    """Dynamic shared memory of one block of the bf16 temporal-layer kernel
    (the mirror of `layout` in `csrc/fused_temporal_layer.cu`): the x tile
    `[P*FP, C]` bf16 (FP = 16*ceil(F/16)), the head's W_qkv columns `[C, 96]`,
    the fp32 partial `[P*F, C+8]` (over the x tile and W_qkv when a block has
    one head), the head's W_out rows `[32, C]`, the q, k, v tiles
    `[P*FP, 32]`, the `[F, F]` fp32 bias and the fp32 LN gamma `[C]`."""
    fp = 16 * -(-f // 16)
    xb = pixels * fp * c * 2
    wb = 192 * c
    pb = -(-(pixels * f * (c + 8) * 4) // 128) * 128
    top = max(xb + wb, pb) if heads_per_block == 1 else xb + wb + pb
    return top + 64 * c + 3 * pixels * fp * 64 + -(-(f * f * 4) // 128) * 128 + 4 * c


def _waves(blocks: int, warps: int, smem: int, sms: int) -> int:
    """Waves of `blocks` blocks of `warps` warps and `smem` bytes on `sms`
    H100 SMs: a block takes 1 KB of shared memory beside its own and
    `_REGS` registers per thread."""
    per_sm = min(_SMEM_PER_SM // (smem + 1024), 65536 // (32 * warps * _REGS), 64 // warps)
    return -(-blocks // (sms * max(per_sm, 1)))


@functools.lru_cache(maxsize=256)
def temporal_layer_plan(b: int, f: int, hw: int, c: int, heads: int, sms: int,
                        cluster: int | None = None) -> dict:
    """Launch plan of the bf16 temporal-layer kernel on a card of `sms` SMs.

    A cluster of K blocks owns a chunk of P pixels of one batch entry, each
    block `heads // K` of its heads; a block runs one warp per 16-row query
    strip, P*ceil(F/16) <= 8 of them. For a given K, P is the largest that
    fits shared memory, cut while the grid has fewer than two blocks per SM.
    Of the clusters (K a divisor of `heads` from 2 to 8) the plan takes the
    smallest whose grid still has a block for every two SMs and fits (each
    block then recomputes the LN and reads the partials of fewer others),
    else the largest that fits. K = 1 (no LN recomputed, no exchange, all
    heads one after another in a block) replaces it where its grid's waves
    times `heads` are at most the cluster's waves times its heads per block
    plus one: a block takes about a head's time per head, and about one more
    for the LN and the exchange (`bench_temporal_layer --scan`). Unless
    `cluster` names K. Raises when no plan fits. Cached: do not change the
    returned dict."""
    kt = -(-f // 16)
    ks = [d for d in range(1, 9) if heads % d == 0]
    if cluster is not None:
        if cluster < 1 or cluster > 8 or heads % cluster:
            raise ValueError(f"fused_temporal_layer: cluster {cluster} for {heads} heads")
        ks = [cluster]
    plans = {}
    for k in ks:
        hpb = heads // k
        p = max(1, min(8 // kt, hw))
        while p > 1 and temporal_layer_smem(f, c, p, hpb) > _MAX_SMEM:
            p -= 1
        while p > 1 and b * -(-hw // p) * k < 2 * sms:
            p -= 1
        smem = temporal_layer_smem(f, c, p, hpb)
        if smem <= _MAX_SMEM:
            grid = (k, -(-hw // p), b)
            plans[k] = {"pixels": p, "cluster": k, "heads_per_block": hpb, "warps": p * kt,
                        "smem": smem, "grid": grid,
                        "waves": _waves(k * grid[1] * b, p * kt, smem, sms)}
    if not plans:
        smem = temporal_layer_smem(f, c, 1, heads // ks[-1])
        raise ValueError(f"fused_temporal_layer: a block needs {smem} bytes of shared memory "
                         f"(F={f}, C={c}, {heads // ks[-1]} heads per block) > {_MAX_SMEM}")
    clustered = [q for k, q in plans.items() if k > 1]
    best = next((q for q in clustered if b * q["grid"][1] * q["cluster"] >= sms / 2),
                clustered[-1] if clustered else None)
    one = plans.get(1)
    if one is not None and (best is None or one["waves"] * heads
                            <= best["waves"] * (best["heads_per_block"] + 1)):
        return one
    return best


# Stages of `csrc/fused_temporal_layer.cu` that an ablation build removes,
# in the order the kernel runs them (`reduce`, the cluster's sum of the
# blocks' partials, only in the bf16 kernel).
ABLATIONS = ("layernorm", "qkv", "rotary", "scores", "softmax", "pv", "outproj", "reduce")


def ablation_defines(stage: str) -> tuple[str, ...]:
    """The preprocessor defines of the build without `stage`; `"full"` is
    the serving kernel itself."""
    if stage == "full":
        return ()
    if stage not in ABLATIONS:
        raise ValueError(f"ablation stage {stage!r} not in {('full',) + ABLATIONS}")
    return (f"LFDM_ABLATE_{stage.upper()}",)


def fused_temporal_layer_ablated(stage, x, gamma, wqkv, wout, bias_flat, cos_t, sin_t,
                                 heads: int, dim_head: int, eps: float = 1e-5):
    """Timing only: :func:`fused_temporal_layer`'s kernel built without one
    of its stages (:data:`ABLATIONS`), on a CUDA tensor. Only `"full"`
    computes the layer (it is the serving kernel, bit for bit); the other
    outputs mean nothing. `full - variant` attributes device time to the
    stage. The TPU harness's `kvbuild`, `kt` and `kt_vm` variants ablate the
    head-tiled K/V of the TPU kernel and have no counterpart here."""
    out = _launch_fused_temporal_layer(
        ablation_defines(stage), x, gamma, wqkv, wout, bias_flat, cos_t, sin_t,
        heads, dim_head, eps)
    fused_temporal_layer_ablated.launches += 1
    return out


def fused_spatial_linear_layer(x, gamma, wqkv, wout, bout,
                               heads: int, dim_head: int, eps: float = 1e-5, partial: bool = False):
    """`x + to_out(linear_attn(to_qkv(LN(x))))` per frame.

    Args:
      x: `[B, F, HW, C]`; gamma: `[C]` fp32; wqkv: `[C, 3*heads*d]`;
      wout: `[heads*d, C]`; bout: `[C]` fp32 (to_out bias).
      partial: the head-shard mode of tensor parallelism: `heads` are one
        rank's heads (its q|k|v columns of `wqkv`, rows of `wout`) and the
        result is the fp32 `to_out` partial over them, with no `bout`, no
        residual and no rounding.

    Returns `[B, F, HW, C]` (fp32 with `partial`). The kernel needs d = 32,
    and in bf16 C % 16 == 0 and 16-byte aligned tensors; two launches per
    call. `.launches` counts every call, `.partial_launches` those in the
    head-shard mode.
    """
    if x.device.type == "cpu":
        return fused_spatial_linear_layer_plain(
            x, gamma, wqkv, wout, bout, heads, dim_head, eps, partial)
    name = "fused_spatial_linear_layer"
    b, f, n, c = x.shape
    hd = heads * dim_head
    _check_layer_args(name, x, gamma, wqkv, wout, hd, (), (bout,))
    _build.require_no_grad(name, x, gamma, wqkv, wout, bout)
    if dim_head != 32 or tuple(bout.shape) != (c,):
        raise ValueError(f"{name}: needs d=32 and bout [C]")
    # per-head normalized contexts, the only intermediate in device memory
    ctx = torch.empty((b, f, heads, dim_head, dim_head), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x, dtype=torch.float32 if partial else x.dtype)
    ints = (b, f, n, c, heads)
    if x.dtype == torch.bfloat16:
        if c % 16:
            raise ValueError(f"{name}: the bf16 kernel needs C % 16 == 0 (C={c})")
        _check_aligned(name, x, gamma, wqkv, wout, bout, ctx, out)
        plan = linear_layer_plan(b, f, n, c, heads, _sm_count(x.device.index), linear_layer_smem())
        cp, op = plan["context"], plan["output"]
        ints += (cp["rows"], cp["head_groups"], cp["splits"], op["rows"], op["cluster"])
    fname = "launch_fused_spatial_linear_layer_" + _suffix(x.dtype)
    fn = _build.bind(name, fname, [_PTR] * 7 + [_INT] * (len(ints) + 1) + [ctypes.c_float, _PTR])
    code = fn(
        *(_build.ptr(t) for t in (x, gamma, wqkv, wout, bout, ctx, out)),
        *ints, int(partial), eps, _build.stream(x.device),
    )
    _build.check(_build.load(name), fname, code)
    fused_spatial_linear_layer.launches += 1
    fused_spatial_linear_layer.partial_launches += int(partial)
    return out


@functools.lru_cache(maxsize=None)
def linear_layer_smem():
    """The bf16 linear-layer kernels' shared memory per block, as the library
    computes it (`fused_spatial_linear_layer_bf16_smem` in
    `csrc/fused_spatial_linear_layer.cu`, the one place of the layout):
    `smem(kernel, c, rows, heads, groups)` bytes, kernel 0 the context launch
    (`groups` head groups), 1 the output launch (clusters of `groups`).
    Builds and loads the library (the card's toolchain)."""
    fn = _build.bind("fused_spatial_linear_layer", "fused_spatial_linear_layer_bf16_smem", [_INT] * 5)
    return lambda kernel, c, rows, heads, groups: fn(kernel, c, rows, heads, groups)


@functools.lru_cache(maxsize=256)
def linear_layer_plan(b: int, f: int, hw: int, c: int, heads: int, sms: int, smem,
                      cluster: int | None = None, rows: int | None = None) -> dict:
    """Launch plan of the bf16 linear-attention layer on a card of `sms` SMs.

    `smem(kernel, c, rows, heads, groups)` is a block's shared memory
    (:func:`linear_layer_smem` on the card). Both launches split the heads
    into G groups, G a divisor of `heads` up to 8 with at most 8 heads per
    group (a context block runs one warp per head), and cut each frame into
    tiles of R rows (pixels), R a multiple of 16 up to 128. The context
    launch runs a block per (head group, split, frame), the KS = min(8,
    tiles) splits of a frame in one cluster (a split takes every KS-th
    tile); the output launch a cluster of G blocks per (tile, frame). Every
    block has 8 warps (a context block's first `heads // G` run one head
    each; all share the copies, LayerNorm and merge). Each launch takes the
    smallest G whose block fits (a block stages the weights of its heads
    once, and more blocks per cluster recompute the LN and exchange more),
    and the largest R that fits, cut while its grid has fewer blocks than
    half the SMs; R is the least for its number of tiles, so the tiles are
    even (`bench_linear_layer --scan`). `cluster` names G for both, `rows`
    names R (the scan). Raises when nothing fits. Cached: do not change
    the returned dict."""
    name = "fused_spatial_linear_layer"
    bf = b * f
    strips = -(-hw // 16)
    groups = [g for g in range(1, 9) if heads % g == 0 and heads // g <= 8]
    if cluster is not None:
        if cluster not in groups:
            raise ValueError(f"{name}: cluster {cluster} for {heads} heads")
        groups = [cluster]
    if rows is not None and (rows < 16 or rows % 16 or rows > 128):
        raise ValueError(f"{name}: rows {rows} (a multiple of 16 up to 128)")

    def even(ns):  # the fewest strips per tile that give the tiles of ns strips
        return 16 * -(-strips // -(-strips // ns))

    def choose(kernel, make):
        for g in groups:
            ns = rows // 16 if rows is not None else min(8, strips)
            while rows is None and ns > 1 and smem(kernel, c, 16 * ns, heads, g) > _MAX_SMEM:
                ns -= 1
            if smem(kernel, c, 16 * ns, heads, g) > _MAX_SMEM:
                continue
            plan = make(g, rows or even(ns))
            while rows is None and ns > 1 and math.prod(plan["grid"]) < sms / 2:
                ns -= 1
                plan = make(g, even(ns))
            return plan
        need = smem(kernel, c, rows or 16, heads, groups[-1])
        raise ValueError(f"{name}: a block needs {need} bytes of shared memory "
                         f"(C={c}, {heads // groups[-1]} heads per block) > {_MAX_SMEM}")

    def context(g, r):
        ks = min(8, -(-hw // r))
        size = smem(0, c, r, heads, g)
        return {"rows": r, "head_groups": g, "splits": ks, "smem": size, "grid": (g, ks, bf)}

    def output(g, r):
        return {"rows": r, "cluster": g, "smem": smem(1, c, r, heads, g), "grid": (g, -(-hw // r), bf)}

    return {"context": choose(0, context), "output": choose(1, output)}


# ------------------------------------------------ head-packed attention


def _rotated_heads(qkv, cos_t, sin_t, heads, dim_head):
    """fp32 rotary on the raw qkv, rounded to its dtype; q, k, v as fp32
    `[B, F, HW, heads, d]` (fp64 stays fp64)."""
    b, f, hw, _ = qkv.shape
    hd = heads * dim_head
    ft = torch.promote_types(qkv.dtype, torch.float32)
    x = qkv.to(ft)
    blk = (x * cos_t.to(ft)[None, :, None] + rotate_pairs(x) * sin_t.to(ft)[None, :, None])
    blk = blk.to(qkv.dtype)
    return tuple(blk[..., i * hd:(i + 1) * hd].reshape(b, f, hw, heads, dim_head).to(ft)
                 for i in range(3))


def _scores(q, k, bias_flat, heads):
    """`[B, HW, heads, F(i), F(j)]` logits shifted by their row max (per head)."""
    b, f = bias_flat.shape[:2]
    s = torch.einsum("bixhd,bjxhd->bxhij", q, k)
    s = s + bias_flat.to(q.dtype).reshape(b, f, heads, f).permute(0, 2, 1, 3)[:, None]
    return s - s.amax(dim=-1, keepdim=True)


def headpacked_forward_plain(qkv, bias_flat, cos_t, sin_t, heads: int, dim_head: int):
    """Plain forward of :func:`headpacked_temporal_attention`: `exp` is
    rounded to qkv's dtype before the numerator and the denominator sums,
    the denominator is clamped at float32 tiny."""
    b, f, hw, _ = qkv.shape
    dt = qkv.dtype
    q, k, v = _rotated_heads(qkv, cos_t, sin_t, heads, dim_head)
    e = torch.exp(_scores(q, k, bias_flat, heads)).to(dt).to(q.dtype)
    num = torch.einsum("bxhij,bjxhd->bixhd", e, v)
    den = e.sum(dim=-1).permute(0, 3, 1, 2)[..., None].clamp_min(_TINY)
    return (num / den).to(dt).reshape(b, f, hw, heads * dim_head)


def headpacked_backward_plain(qkv, bias_flat, cos_t, sin_t, do, heads: int, dim_head: int):
    """Plain recompute-based backward: `(dqkv, dbias)` for the cotangent
    `do [B, F, HW, heads*d]`. `dqkv` is the gradient of the raw qkv (rotary
    adjoint applied), in qkv's dtype; `dbias [B, F, heads*F]` is summed
    over all pixels. Rounds to qkv's dtype where the kernel does: the
    probabilities' row sums, `prob·dp` before its row sum, `prob` for dv,
    `ds` for dq and dk, and dk, dv before the adjoint."""
    b, f, hw, _ = qkv.shape
    dt = qkv.dtype
    q, k, v = _rotated_heads(qkv, cos_t, sin_t, heads, dim_head)
    ft = q.dtype
    rnd = lambda t: t.to(dt).to(ft)
    e = torch.exp(_scores(q, k, bias_flat, heads))
    prob = e / rnd(e).sum(dim=-1, keepdim=True).clamp_min(_TINY)
    dof = do.reshape(b, f, hw, heads, dim_head).to(ft)
    dp = torch.einsum("bixhd,bjxhd->bxhij", dof, v)
    c = rnd(prob * dp).sum(dim=-1, keepdim=True)
    ds = prob * (dp - c)
    dbias = ds.sum(dim=1).permute(0, 2, 1, 3).reshape(b, f, heads * f).to(bias_flat.dtype)
    dst = rnd(ds)
    dq = torch.einsum("bxhij,bjxhd->bixhd", dst, k)
    dk = rnd(torch.einsum("bxhij,bixhd->bjxhd", dst, q))
    dv = rnd(torch.einsum("bxhij,bixhd->bjxhd", rnd(prob), dof))
    dx = torch.cat([t.reshape(b, f, hw, heads * dim_head) for t in (dq, dk, dv)], dim=-1)
    cos = cos_t.to(ft)[None, :, None]
    sin = sin_t.to(ft)[None, :, None]
    return (dx * cos - rotate_pairs(dx) * sin).to(dt), dbias


def _check_headpacked_args(qkv, bias_flat, cos_t, sin_t, heads, dim_head):
    name = "headpacked_temporal_attention"
    if qkv.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {qkv.dtype} (want float32 or bfloat16)")
    if qkv.ndim != 4:
        raise ValueError(f"{name}: qkv must be [B, F, HW, 3*heads*d], got {tuple(qkv.shape)}")
    b, f, hw, thd = qkv.shape
    hd = heads * dim_head
    if dim_head != 32 or f > 64:
        raise ValueError(f"{name}: needs d=32, F<=64 (d={dim_head}, F={f})")
    want = {"qkv": (qkv, (b, f, hw, 3 * hd)), "bias_flat": (bias_flat, (b, f, heads * f)),
            "cos_t": (cos_t, (f, 3 * hd)), "sin_t": (sin_t, (f, 3 * hd))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
        if t.device != qkv.device:
            raise ValueError(f"{name}: arguments on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: arguments must be contiguous")
    if cos_t.dtype != qkv.dtype or sin_t.dtype != qkv.dtype:
        raise TypeError(f"{name}: rotary table dtype != qkv dtype {qkv.dtype}")
    if bias_flat.dtype != torch.float32:
        raise TypeError(f"{name}: bias_flat {bias_flat.dtype} where float32 is required")
    if qkv.dtype == torch.bfloat16:
        _check_aligned(name, qkv, cos_t, sin_t)


def _check_aligned(name, *tensors):
    """The bf16 kernels move 16-byte vectors: their tensors must start on
    a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 arguments must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _headpacked_chunks(qkv, heads):
    """Pixel chunks per (batch, head): a bf16 launch runs one block per
    chunk and aims at four blocks for each SM of the card; an fp32 backward
    block walks up to 16 pixels (the fp32 forward takes no chunks)."""
    b, _, hw, _ = qkv.shape
    if qkv.dtype == torch.bfloat16:
        blocks = 4 * _sm_count(qkv.device.index)
        return max(1, min(hw, -(-blocks // (b * heads))))
    return -(-hw // max(1, min(16, hw // 64)))


def _launch_headpacked_fwd(qkv, bias_flat, cos_t, sin_t, heads):
    b, f, hw, thd = qkv.shape
    out = torch.empty((b, f, hw, thd // 3), dtype=qkv.dtype, device=qkv.device)
    name = "launch_headpacked_fwd_" + _suffix(qkv.dtype)
    fn = _build.bind("headpacked_attention", name, [_PTR] * 5 + [_INT] * 5 + [_PTR])
    code = fn(*(_build.ptr(t) for t in (qkv, bias_flat, cos_t, sin_t, out)),
              b, f, hw, heads, _headpacked_chunks(qkv, heads), _build.stream(qkv.device))
    _build.check(_build.load("headpacked_attention"), name, code)
    headpacked_temporal_attention.launches += 1
    return out


def _launch_headpacked_bwd(qkv, bias_flat, cos_t, sin_t, do, heads, want_dbias: bool):
    b, f, hw, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    if qkv.dtype == torch.bfloat16:
        _check_aligned("headpacked_temporal_attention", do)
    # a block's [F, F] partial of dbias over its chunk of pixels is summed
    # with the other chunks' by a second launch, in index order
    chunks = _headpacked_chunks(qkv, heads)
    dbias = partial = None
    if want_dbias:
        partial = torch.empty((b, heads, chunks, f, f), dtype=torch.float32, device=qkv.device)
        dbias = torch.empty_like(bias_flat)
    name = "launch_headpacked_bwd_" + _suffix(qkv.dtype)
    fn = _build.bind("headpacked_attention", name, [_PTR] * 8 + [_INT] * 5 + [_PTR])
    null = ctypes.c_void_p(None)
    code = fn(*(_build.ptr(t) for t in (qkv, bias_flat, cos_t, sin_t, do, dqkv)),
              null if partial is None else _build.ptr(partial),
              null if dbias is None else _build.ptr(dbias),
              b, f, hw, heads, chunks, _build.stream(qkv.device))
    _build.check(_build.load("headpacked_attention"), name, code)
    headpacked_temporal_attention.backward_launches += 1
    return dqkv, dbias


class _HeadpackedAttention(torch.autograd.Function):
    """Saves the inputs and recomputes the probabilities in the backward;
    `use_kernel` picks the CUDA kernels or the plain forward and backward."""

    @staticmethod
    def forward(ctx, qkv, bias_flat, cos_t, sin_t, heads, dim_head, use_kernel):
        ctx.save_for_backward(qkv, bias_flat, cos_t, sin_t)
        ctx.heads, ctx.dim_head, ctx.use_kernel = heads, dim_head, use_kernel
        if use_kernel:
            return _launch_headpacked_fwd(qkv, bias_flat, cos_t, sin_t, heads)
        return headpacked_forward_plain(qkv, bias_flat, cos_t, sin_t, heads, dim_head)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        qkv, bias_flat, cos_t, sin_t = ctx.saved_tensors
        want_dbias = ctx.needs_input_grad[1]
        do = do.to(qkv.dtype).contiguous()
        if ctx.use_kernel:
            dqkv, dbias = _launch_headpacked_bwd(
                qkv, bias_flat, cos_t, sin_t, do, ctx.heads, want_dbias)
        else:
            dqkv, dbias = headpacked_backward_plain(
                qkv, bias_flat, cos_t, sin_t, do, ctx.heads, ctx.dim_head)
        return dqkv, (dbias if want_dbias else None), None, None, None, None, None


def headpacked_temporal_attention(qkv, bias_flat, cos_t, sin_t, heads: int, dim_head: int):
    """Differentiable temporal attention on the raw `to_qkv` output.

    Args:
      qkv: `[B, F, HW, 3*heads*d]`, rotary NOT applied (it is folded in
        through `cos_t`/`sin_t`), bf16 or fp32.
      bias_flat: `[B, F, heads*F]` fp32 (:func:`build_bias_flat`); may hold
        `NEG_INF` off the diagonal (focus rows).
      cos_t/sin_t: `[F, 3*heads*d]` in qkv's dtype (:func:`rotary_tables`).

    Returns `[B, F, HW, heads*d]`. Gradients flow to `qkv` and `bias_flat`.
    CPU tensors take the plain forward and backward; CUDA tensors launch
    `csrc/headpacked_attention.cu` (d = 32, F <= 64) or raise.
    `.launches` / `.backward_launches` count the kernel launches.
    """
    use_kernel = qkv.device.type != "cpu"
    if use_kernel:
        _check_headpacked_args(qkv, bias_flat, cos_t, sin_t, heads, dim_head)
    return _HeadpackedAttention.apply(qkv, bias_flat, cos_t, sin_t, heads, dim_head, use_kernel)


def headpacked_temporal_attention_plain(qkv, bias_flat, cos_t, sin_t, heads: int, dim_head: int):
    """Plain version of :func:`headpacked_temporal_attention` on any device
    (same arguments, same rounding points, differentiable)."""
    return _HeadpackedAttention.apply(qkv, bias_flat, cos_t, sin_t, heads, dim_head, False)


# ------------------------------------------------ packed attention


def packed_temporal_attention_plain(qkv, bias, heads: int, dim_head: int, pack: int):
    """Plain version of :func:`packed_temporal_attention` (same arguments):
    P pixels per `[P*F, d]` tile against the whole `[P*F, P*F]` bias, fp32
    scores and softmax, the probabilities rounded to qkv's dtype before the
    fp32-accumulated `p.v`."""
    b, hw, f, _ = qkv.shape
    hd = heads * dim_head
    dt = qkv.dtype
    if hw % pack:
        raise ValueError(f"packed_temporal_attention: pack {pack} does not divide HW {hw}")
    pf = pack * f
    blk = qkv.reshape(b, hw // pack, pf, 3, heads, dim_head).float()
    q, k, v = blk[..., 0, :, :], blk[..., 1, :, :], blk[..., 2, :, :]
    s = torch.einsum("bnihd,bnjhd->bnhij", q, k) + bias.float()[:, None]
    s = s - s.amax(dim=-1, keepdim=True).detach()
    prob = torch.softmax(s, dim=-1).to(dt).float()
    o = torch.einsum("bnhij,bnjhd->bnihd", prob, v)
    return o.to(dt).reshape(b, hw, f, hd)




def _packed_chunks(hw: int, batch: int, heads: int, f: int, pack: int, sms: int) -> int:
    """Pixel chunks per (batch, head) of a bf16 packed-attention launch, one
    block each: about two blocks for each of the card's `sms` SMs (two
    blocks of eight warps fit on one), every chunk `ceil(hw / chunks)`
    pixels but the last, none empty, and short enough that the block's
    `min(pack, chunk)` diagonal `[F, F]` bias blocks fit in shared memory
    beside eight warps' q, k, v tiles."""
    chunks = max(1, min(hw, -(-2 * sms // (batch * heads))))
    ppb = -(-hw // chunks)
    tiles = 8 * 3 * 16 * -(-f // 16) * 64
    fit = (_MAX_SMEM - tiles - 127) // (f * f * 4)  # 8 slots at F = 64
    if min(pack, ppb) > fit:
        ppb = fit
    return -(-hw // ppb)


def packed_temporal_attention(qkv, bias, heads: int, dim_head: int, pack: int):
    """Masked attention over the frame axis, P pixels per tile.

    Args:
      qkv: `[B, HW, F, 3*heads*d]`, q|k|v on the last axis, rotary and
        q-scale already applied; bf16 or fp32.
      bias: `[B, heads, P*F, P*F]` fp32 (:func:`build_bias`): cross-pixel
        entries must be NEG_INF.
      pack: P pixels per tile; must divide HW (:func:`pick_pack`).

    Returns `[B, HW, F, heads*d]`. CPU tensors take the plain version; CUDA
    tensors launch `csrc/packed_attention.cu` (d = 32, F <= 64), which reads
    only the diagonal `[F, F]` blocks of `bias`, or raise; in bf16, `qkv`
    must start on a 16-byte boundary. Forward-only, as the JAX kernel: it
    raises when a gradient is asked of it on the card.
    """
    if qkv.device.type == "cpu":
        return packed_temporal_attention_plain(qkv, bias, heads, dim_head, pack)
    name = "packed_temporal_attention"
    if qkv.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {qkv.dtype} (want float32 or bfloat16)")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias {bias.dtype} where float32 is required")
    if qkv.ndim != 4:
        raise ValueError(f"{name}: qkv must be [B, HW, F, 3*heads*d], got {tuple(qkv.shape)}")
    b, hw, f, thd = qkv.shape
    hd = heads * dim_head
    if dim_head != 32 or f > 64:
        raise ValueError(f"{name}: needs d=32, F<=64 (d={dim_head}, F={f})")
    if pack < 1 or hw % pack:
        raise ValueError(f"{name}: pack {pack} does not divide HW {hw}")
    if thd != 3 * hd or tuple(bias.shape) != (b, heads, pack * f, pack * f):
        raise ValueError(f"{name}: shapes {tuple(qkv.shape)} {tuple(bias.shape)}")
    if bias.device != qkv.device:
        raise ValueError(f"{name}: arguments on different devices")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: arguments must be contiguous")
    _build.require_no_grad(name, qkv, bias)
    out = torch.empty((b, hw, f, hd), dtype=qkv.dtype, device=qkv.device)
    chunks = 1
    if qkv.dtype == torch.bfloat16:
        _check_aligned(name, qkv, out)
        chunks = _packed_chunks(hw, b, heads, f, pack, _sm_count(qkv.device.index))
    fname = "launch_packed_attention_" + _suffix(qkv.dtype)
    fn = _build.bind("packed_attention", fname, [_PTR] * 3 + [_INT] * 6 + [_PTR])
    code = fn(_build.ptr(qkv), _build.ptr(bias), _build.ptr(out), b, f, hw, heads, pack, chunks,
              _build.stream(qkv.device))
    _build.check(_build.load("packed_attention"), fname, code)
    packed_temporal_attention.launches += 1
    return out


fused_temporal_layer.launches = 0
fused_temporal_layer.partial_launches = 0
fused_temporal_layer_ablated.launches = 0
packed_temporal_attention.launches = 0
fused_spatial_linear_layer.launches = 0
fused_spatial_linear_layer.partial_launches = 0
headpacked_temporal_attention.launches = 0
headpacked_temporal_attention.backward_launches = 0

"""Conditional 3D UNet, the denoiser (counterpart of
`cvpr23_lfdm_tpu/models/unet3d.py::Unet3D`), in the four forms of the JAX
package, chosen by `temporal_attn_impl` and named as there:

* `"pallas3"`, the serving form (forward-only): every PreNorm
  temporal-attention layer is one :func:`ops.attention.fused_temporal_layer`
  and every PreNorm linear attention layer one
  :func:`ops.attention.fused_spatial_linear_layer`.
* `"pallas2"`, the training form (differentiable): `x + attn(LN(x))` with
  the temporal attention as `to_qkv` ->
  :func:`ops.attention.headpacked_temporal_attention` (forward and backward
  kernels) -> `to_out`, and the linear attention unfused in plain PyTorch.
* `"pallas"` (forward-only): `to_qkv` -> rotary and q-scale in the qkv
  dtype -> :func:`ops.attention.packed_temporal_attention` -> `to_out`; the
  linear attention unfused.
* `"xla"` (differentiable, no kernel): the temporal attention as the JAX
  model's einsums, the scores kept in the compute dtype under bf16; the
  linear attention unfused.

`fused_norm=True` (any form, forward-only) makes every `Block` one
:func:`ops.norm.groupnorm_film_silu` after its convolution's product (the
bf16 conv bias folded in). The UNet's default is `False`, as in the JAX
model, where XLA fuses the chain into its neighbours on a TPU; eager
PyTorch on a GPU fuses nothing, so the serving entry points build it
fused (`diffusion/flow_diffusion.py::build_unet`).

All forms have the same parameters, so one state dict loads into each. In
fp32 they agree to ~1e-4; in bf16 they round at different points.
:func:`resolve_attn_impl` maps a config value to a form: a value that names
a form gives that form, and only `"auto"` lets the entry point choose
(serving `pallas3`, training `pallas2`, as the JAX CLIs do on a TPU).

Layout `[B, F, H, W, C]`; the "(1, k, k)" pseudo-3D convs are 2D convs over
the folded `B*F` batch. Module and parameter names follow
the JAX variable tree. Parameters stay fp32; `dtype` is the compute dtype
(bf16 for serving), with GroupNorm/LayerNorm statistics and softmax in fp32
and the time/condition MLP and output heads in fp32, as in the JAX model.

Reference quirks kept: the init temporal attention gets no focus mask, and
the linear and mid attention use dim_head 32 whatever `attn_dim_head` is.

:func:`shard_unet` turns a built UNet of any form into its tensor-parallel
form over a mesh's `model` axis (the JAX package's GSPMD partitioning of
`UNET_TP_RULES`, with the collectives written out); a module whose `tp`
is None runs as above, bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d, Dense, _compute_dtype, split_bias
from cvpr23_lfdm_torch.ops import attention as attn_ops
from cvpr23_lfdm_torch.ops import norm as norm_ops
from cvpr23_lfdm_torch.parallel.mesh import (
    copy_to_model, gather_channels, model_slice, reduce_from_model, replicate, shard_variables,
)


ATTN_IMPLS = ("xla", "pallas", "pallas2", "pallas3")


def resolve_attn_impl(value: str, training: bool) -> str:
    """The UNet form for a config's `temporal_attn_impl`. A value that
    names a form (`xla`, `pallas`, `pallas2`, `pallas3`; the JAX package's
    `_interpret` suffix is dropped) gives that form. Only `"auto"` lets the
    entry point choose: `pallas2` for training, `pallas3` for serving. Any
    other value raises."""
    if value == "auto":
        return "pallas2" if training else "pallas3"
    impl = value.removesuffix("_interpret")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"temporal_attn_impl {value!r}: not 'auto' nor one of {ATTN_IMPLS}")
    return impl


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t [B] -> [B, dim]` (sin half, then cos half)."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _rel_pos_bucket(rel: np.ndarray, num_buckets: int = 32, max_distance: int = 32) -> np.ndarray:
    """T5 relative-position bucketing, int64 numpy (as the JAX package)."""
    ret = np.zeros_like(rel)
    n = -rel
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    ret += np.where(is_small, n, val_large)
    return ret


class RelativePositionBias(nn.Module):
    """Learned T5-style temporal attention bias -> `[heads, F, F]` fp32."""

    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n: int) -> torch.Tensor:
        idx = _rel_pos_index(n, self.num_buckets, self.max_distance, self.relative_attention_bias.weight.device)
        return self.relative_attention_bias(idx).permute(2, 0, 1)


@functools.cache
def _rel_pos_index(n: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """The `[n, n]` bucket index on `device`, uploaded once per arguments
    (as `_rotary_freqs` and `ops/attention.py::rotary_tables`): an eval
    enqueues its work without waiting on a copy."""
    pos = np.arange(n, dtype=np.int64)
    return torch.from_numpy(_rel_pos_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)).to(device)


class ChannelLayerNorm(nn.Module):
    """Gamma-only LN over channels, eps inside the sqrt. fp32 input: plain
    fp32 math; lower precision: fp32 statistics, normalize in that dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            mean = x.mean(dim=-1, keepdim=True)
            var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
            return (x - mean) / torch.sqrt(var + self.eps) * self.gamma
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        return (x - mean.to(x.dtype)) * inv * self.gamma.to(x.dtype)


@functools.cache
def _rotary_freqs(dim_head: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved rotary tables `[n, dim_head]` fp32 over the first
    min(32, dim_head) channels (cos 1, sin 0 beyond)."""
    rot = min(32, dim_head)
    freqs = 1.0 / (10000.0 ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    ang = np.repeat(np.outer(np.arange(n, dtype=np.float64), freqs), 2, axis=-1)
    cos, sin = np.ones((n, dim_head)), np.zeros((n, dim_head))
    cos[:, :rot], sin[:, :rot] = np.cos(ang), np.sin(ang)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return as_t(cos), as_t(sin)


class TemporalAttention(nn.Module):
    """Attention over the frame axis, batched over pixels.

    `impl="pallas3"` (serving): the whole PreNorm layer (LN + qkv + rotary +
    attention + out-proj + residual) is one forward-only fused kernel and
    `forward` takes the raw `x` with `prenorm_gamma`. The other forms work
    on the normalized input as `to_qkv` -> attention -> `to_out`:
    `"pallas2"` (training) through the differentiable head-packed kernel,
    `"pallas"` through rotary in the qkv dtype and the forward-only packed
    kernel, `"xla"` through plain einsums."""

    tp = None  # the mesh of the tensor-parallel form (`shard_unet`)

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.impl = impl
        self.fused = impl == "pallas3"
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, 3 * hidden, bias=False, dtype=dtype)
        self.to_out = Dense(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x, prenorm_gamma=None, pos_bias=None, focus_present_mask=None):
        b, f, h, w, c = x.shape
        cdt = self.dtype
        if pos_bias is not None:
            pos_bias = model_slice(pos_bias, self.tp)  # this rank's heads
        if self.impl == "xla":
            return self._einsum_attention(x, pos_bias, focus_present_mask)
        if pos_bias is None:
            pos_bias = torch.zeros((self.heads, f, f), device=x.device)
        if self.impl == "pallas":
            return self._packed_attention(x, pos_bias, focus_present_mask)
        bias_flat = attn_ops.build_bias_flat(pos_bias, b, f, focus_present_mask)
        cos_t, sin_t = attn_ops.rotary_tables(
            f, self.heads, self.dim_head, self.dim_head ** -0.5, cdt, x.device
        )
        if not self.fused:
            qkv = self.to_qkv(x).reshape(b, f, h * w, -1)
            out = attn_ops.headpacked_temporal_attention(
                qkv, bias_flat, cos_t, sin_t, self.heads, self.dim_head)
            return project_out(self.to_out, out.reshape(b, f, h, w, -1), self.tp)
        xr = x.reshape(b, f, h * w, c).to(cdt).contiguous()
        out = attn_ops.fused_temporal_layer(
            xr, prenorm_gamma.float().contiguous(),
            self.to_qkv.weight.to(cdt).t().contiguous(),
            self.to_out.weight.to(cdt).t().contiguous(),
            bias_flat, cos_t, sin_t, self.heads, self.dim_head, partial=self.tp is not None,
        )
        if self.tp is not None:  # the heads' fp32 sum, rounded once, then the residual
            out = xr + reduce_from_model(out, self.tp).to(cdt)
        return out.reshape(b, f, h, w, c).to(x.dtype)

    def _packed_attention(self, x, pos_bias, focus_present_mask):
        """`pallas`: rotary and q-scale as one elementwise pass in the qkv
        dtype, then the packed kernel on `[B, HW, F, 3hd]`."""
        b, f, h, w, _ = x.shape
        hw = h * w
        qkv = self.to_qkv(x).reshape(b, f, hw, -1)
        pack = attn_ops.pick_pack(hw, f)
        bias = attn_ops.build_bias(pos_bias, b, pack, f, focus_present_mask)
        cos_t, sin_t = attn_ops.rotary_tables(
            f, self.heads, self.dim_head, self.dim_head ** -0.5, qkv.dtype, x.device)
        qkv = qkv * cos_t[None, :, None, :] + attn_ops.rotate_pairs(qkv) * sin_t[None, :, None, :]
        out = attn_ops.packed_temporal_attention(
            qkv.swapaxes(1, 2).contiguous(), bias, self.heads, self.dim_head, pack)
        return project_out(self.to_out, out.swapaxes(1, 2).reshape(b, f, h, w, -1), self.tp)

    def _einsum_attention(self, x, pos_bias, focus_present_mask):
        """`xla`: the JAX model's einsum form. Under a lower-precision
        compute dtype the scores are accumulated to that dtype and the
        softmax input is that rounded value; the softmax itself is fp32."""
        b, f, h, w, _ = x.shape
        heads, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, heads, d)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        q = q * (d ** -0.5)
        cos, sin = (t.to(q.dtype)[None, :, None, None, :] for t in _rotary_freqs(d, f, x.device))
        q = q * cos + attn_ops.rotate_pairs(q) * sin
        k = k * cos + attn_ops.rotate_pairs(k) * sin
        sim = torch.einsum("bixhd,bjxhd->bxhij", q, k)
        if pos_bias is not None:
            sim = sim + pos_bias[None, None].to(sim.dtype)
        if focus_present_mask is not None:
            eye = torch.eye(f, dtype=torch.bool, device=x.device)
            keep = eye | ~focus_present_mask[:, None, None, None, None]
            lowest = torch.full((), torch.finfo(torch.float32).min, device=x.device).to(sim.dtype)
            sim = torch.where(keep, sim, lowest)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bxhij,bjxhd->bixhd", attn, v)
        return project_out(self.to_out, out.reshape(b, f, h, w, heads * d), self.tp)


class SpatialLinearAttention(nn.Module):
    """Softmax-kernel linear attention per frame: one forward-only fused
    PreNorm layer (`impl="pallas3"`), or its differentiable unfused form in
    plain PyTorch on the normalized input (every other form; it reaches no
    kernel)."""

    tp = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.fused = impl == "pallas3"
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, 3 * hidden, bias=False, dtype=dtype)
        self.to_out = Dense(hidden, dim, bias=True, dtype=dtype)

    def _unfused(self, x):
        b, f, h, w, _ = x.shape
        heads, d = self.heads, self.dim_head
        dt = x.dtype
        # exp and the normalizing divisions in the compute dtype, the max
        # and the sums in fp32 (as the JAX model)
        cdt = dt
        tiny = torch.finfo(torch.float32).tiny
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, heads, d)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        qf = q.float()
        eq = torch.exp((qf - qf.amax(dim=-1, keepdim=True).detach()).to(cdt))
        den = eq.float().sum(dim=-1, keepdim=True).clamp_min(tiny).to(cdt)
        q = (eq / den).to(dt) * (d ** -0.5)
        kf = k.float()
        ek = torch.exp((kf - kf.amax(dim=2, keepdim=True).detach()).to(cdt))
        k = (ek / ek.float().sum(dim=2, keepdim=True).to(cdt)).to(dt)
        context = torch.einsum("bfnhd,bfnhe->bfhde", k, v)
        out = torch.einsum("bfhde,bfnhd->bfnhe", context, q)
        return project_out(self.to_out, out.reshape(b, f, h, w, heads * d), self.tp)

    def forward(self, x, prenorm_gamma=None):
        if not self.fused:
            return self._unfused(x)
        b, f, h, w, c = x.shape
        cdt = self.dtype
        xr = x.reshape(b, f, h * w, c).to(cdt).contiguous()
        bout = self.to_out.bias.float().contiguous()
        out = attn_ops.fused_spatial_linear_layer(
            xr, prenorm_gamma.float().contiguous(),
            self.to_qkv.weight.to(cdt).t().contiguous(),
            self.to_out.weight.to(cdt).t().contiguous(),
            bout, self.heads, self.dim_head, partial=self.tp is not None,
        )
        if self.tp is not None:  # the heads' fp32 sum + b_out, rounded once, then the residual
            out = xr + (reduce_from_model(out, self.tp) + bout).to(cdt)
        return out.reshape(b, f, h, w, c).to(x.dtype)


class SpatialAttention(nn.Module):
    """Full attention over pixels, batched over frames (mid block only)."""

    fused = False
    tp = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, 3 * hidden, bias=False, dtype=dtype)
        self.to_out = Dense(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x):
        b, f, h, w, _ = x.shape
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, self.heads, self.dim_head)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)  # each [B, F, heads, HW, d]
        q = q * (self.dim_head ** -0.5)
        sim = torch.einsum("bfhid,bfhjd->bfhij", q, k).float()
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bfhij,bfhjd->bfhid", attn, v)
        out = out.permute(0, 1, 3, 2, 4).reshape(b, f, h, w, hidden)
        return project_out(self.to_out, out, self.tp)


class PreNormResidual(nn.Module):
    """x + attn(LN(x)); fused attention layers take the LN gamma instead."""

    def __init__(self, dim: int, attn_cls, heads: int, dim_head: int, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.attn = attn_cls(dim, heads, dim_head, dtype=dtype, impl=impl)

    def forward(self, x, **kwargs):
        if self.attn.fused:
            return self.attn(x, prenorm_gamma=self.norm.gamma, **kwargs)
        return x + self.attn(copy_to_model(self.norm(x), self.attn.tp), **kwargs)


class Conv2plus1d(nn.Module):
    """(1, k, k) pseudo-3D conv as a frame-folded 2D conv."""

    tp = None  # tensor-parallel form: this rank's output channels

    def __init__(self, cin: int, cout: int, k: int, dtype=None, bias: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, bias=bias, dtype=dtype)

    def product(self, x) -> tuple:
        """`(y, after)` of :meth:`Conv2d.product`: the convolution and the
        bias still to add after it."""
        b, f, h, w, c = x.shape
        y, after = self.conv.product(copy_to_model(x, self.tp).reshape(b * f, h, w, c))
        return y.reshape(b, f, h, w, -1), after

    def forward(self, x):
        y, after = self.product(x)
        return y if after is None else y + after


class GroupNorm(nn.Module):
    """GroupNorm over (F, H, W, C/G) per batch entry: fp32 statistics
    (var = E[x²]−mean², clipped at 0), fp32 normalize, result in `dtype`."""

    tp = None  # tensor-parallel form: x holds this rank's whole groups

    def __init__(self, c: int, groups: int = 8, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def affine(self) -> tuple:
        """(groups, weight, bias) of the channels this rank's x holds."""
        groups = self.groups if self.tp is None else self.groups // self.tp.model_size
        return groups, model_slice(self.weight, self.tp), model_slice(self.bias, self.tp)

    def forward(self, x):
        groups, weight, bias = self.affine()
        shape = x.shape
        xf = x.float().reshape(shape[0], -1, groups, shape[-1] // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(shape) * weight + bias
        return y.to(self.dtype)


class Block(nn.Module):
    """conv(1,3,3) -> GroupNorm(8) -> FiLM -> SiLU. With `fused_norm` the
    chain after the convolution's product is one forward-only
    :func:`ops.norm.groupnorm_film_silu` on the GroupNorm's parameters,
    which also adds the bias that a bf16 convolution adds after its rounded
    product (`pre_bias`; in fp32 the bias stays inside the convolution)."""

    def __init__(self, cin: int, cout: int, groups: int = 8, dtype=torch.float32,
                 fused_norm: bool = False):
        super().__init__()
        self.dtype, self.fused_norm = dtype, fused_norm
        self.proj = Conv2plus1d(cin, cout, 3, dtype=dtype)
        self.norm = GroupNorm(cout, groups, dtype=dtype)

    def forward(self, x, scale_shift=None):
        if self.fused_norm:
            x, pre_bias = self.proj.product(x)
            scale, shift = scale_shift if scale_shift is not None else (None, None)
            groups, weight, bias = self.norm.affine()
            return norm_ops.groupnorm_film_silu(
                x, weight, bias, scale, shift, groups=groups, eps=self.norm.eps, pre_bias=pre_bias)
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0).to(self.dtype) + shift.to(self.dtype)
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two FiLM blocks + 1x1x1 residual conv (a Dense on channel-last)."""

    def __init__(self, cin: int, cout: int, cond_dim: int | None, groups: int = 8,
                 dtype=torch.float32, fused_norm: bool = False):
        super().__init__()
        self.dtype = dtype
        self.mlp = Dense(cond_dim, 2 * cout, dtype=dtype) if cond_dim else None
        self.block1 = Block(cin, cout, groups, dtype, fused_norm)
        self.block2 = Block(cout, cout, groups, dtype, fused_norm)
        self.res_conv = Dense(cin, cout, dtype=dtype) if cin != cout else None

    tp = None  # tensor-parallel form: each Block on this rank's channels

    def forward(self, x, cond_emb=None):
        # tensor-parallel form: the rank's channels through both Blocks (its
        # FiLM scale and shift columns, its GroupNorm groups), gathered
        # between them and at the end
        mesh = self.tp
        scale_shift = None
        if cond_emb is not None:
            t = self.mlp(copy_to_model(F.silu(cond_emb), mesh))[:, None, None, None, :]
            scale_shift = t.chunk(2, dim=-1)
        h = self.block2(gather_channels(self.block1(x, scale_shift), mesh))
        if self.res_conv is not None:
            return gather_channels((h + self.res_conv(copy_to_model(x, mesh))).to(self.dtype), mesh)
        return (gather_channels(h, mesh) + x).to(self.dtype)


class Downsample(nn.Module):
    """(1,4,4)/(1,2,2) strided conv."""

    tp = None  # tensor-parallel form: this rank's output channels, gathered

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim, dim, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = self.conv(copy_to_model(x, self.tp).reshape(b * f, h, w, c))
        return gather_channels(y.reshape(b, f, h // 2, w // 2, -1), self.tp)


class Upsample(nn.Module):
    """ConvTranspose (1,4,4)/(1,2,2) pad 1 (`use_deconv`), or nearest-2x +
    zero-padded (1,3,3) conv. The deconv weight is `[C_in, C_out, 4, 4]`
    with `W[i, o, a, b] = K[3-a, 3-b, i, o]` for the JAX dilated-conv kernel K."""

    def __init__(self, dim: int, use_deconv: bool = True, dtype=torch.float32):
        super().__init__()
        self.use_deconv, self.dtype = use_deconv, dtype
        if use_deconv:
            self.weight = nn.Parameter(torch.empty(dim, dim, 4, 4))
            self.bias = nn.Parameter(torch.zeros(dim))
            nn.init.normal_(self.weight, std=(dim * 16) ** -0.5)
        else:
            self.conv = Conv2d(dim, dim, 3, dtype=dtype)

    tp = None  # tensor-parallel form: this rank's output channels, gathered

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = copy_to_model(x, self.tp).reshape(b * f, h, w, c)
        if self.use_deconv:
            dt = self.dtype
            inside, after = split_bias(self.bias, dt)
            y = F.conv_transpose2d(
                y.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), inside, stride=2, padding=1,
            ).permute(0, 2, 3, 1)
            if after is not None:
                y = y + after
        else:
            y = self.conv(y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return gather_channels(y.reshape(b, f, 2 * h, 2 * w, -1), self.tp)


class Unet3D(nn.Module):
    """Input `[B, F, H, W, 3]` noisy latent (+ `fea [B, Ff, H, W, Cf]`,
    Ff in {1, F}), output `[B, F, H, W, 3]` fp32 (2 flow + 1 conf)."""

    tp = None  # the mesh of the tensor-parallel form (`shard_unet`)
    tp_shapes = None  # and its one-process state-dict shapes, by key (`gather_variables`)

    def __init__(self, dim: int = 64, cond_dim: int = 768, dim_mults=(1, 2, 4, 8),
                 attn_heads: int = 8, attn_dim_head: int = 32, learn_null_cond: bool = False,
                 use_deconv: bool = True, use_final_activation: bool = False,
                 dtype=torch.float32, fea_channels: int = 256,
                 temporal_attn_impl: str = "xla", fused_norm: bool | None = None):
        super().__init__()
        if temporal_attn_impl not in ATTN_IMPLS:
            raise ValueError(f"temporal_attn_impl {temporal_attn_impl!r} not in {ATTN_IMPLS}")
        impl = self.temporal_attn_impl = temporal_attn_impl
        fn = self.fused_norm = bool(fused_norm)  # None is False, as in the JAX model
        self.dim, self.cond_dim, self.dtype = dim, cond_dim, dtype
        self.learn_null_cond = learn_null_cond
        self.use_final_activation = use_final_activation
        heads, g, dt = attn_heads, 8, dtype  # GroupNorm(8) throughout

        self.time_rel_pos_bias = RelativePositionBias(heads=heads, max_distance=32)
        self.init_conv = Conv2plus1d(3, dim, 7, dtype=dt)
        self.init_conv_fea = Conv2plus1d(fea_channels, dim, 7, dtype=dt, bias=False)
        self.init_temporal_attn = PreNormResidual(dim, TemporalAttention, heads, attn_dim_head, dt, impl)
        time_dim = dim * 4
        self.time_mlp_1 = Dense(dim, time_dim)
        self.time_mlp_2 = Dense(time_dim, time_dim)
        if learn_null_cond:
            self.null_cond_emb = nn.Parameter(torch.randn(cond_dim))
        emb_dim = time_dim + cond_dim

        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        n = len(self.in_out)
        for ind, (din, dout) in enumerate(self.in_out):
            setattr(self, f"downs_{ind}_block1", ResnetBlock(din, dout, emb_dim, g, dt, fn))
            setattr(self, f"downs_{ind}_block2", ResnetBlock(dout, dout, emb_dim, g, dt, fn))
            setattr(self, f"downs_{ind}_spatial_attn",
                    PreNormResidual(dout, SpatialLinearAttention, heads, 32, dt, impl))
            setattr(self, f"downs_{ind}_temporal_attn",
                    PreNormResidual(dout, TemporalAttention, heads, attn_dim_head, dt, impl))
            if ind < n - 1:
                setattr(self, f"downs_{ind}_downsample", Downsample(dout, dt))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, emb_dim, g, dt, fn)
        self.mid_spatial_attn = PreNormResidual(mid, SpatialAttention, heads, 32, dt, impl)
        self.mid_temporal_attn = PreNormResidual(mid, TemporalAttention, heads, attn_dim_head, dt, impl)
        self.mid_block2 = ResnetBlock(mid, mid, emb_dim, g, dt, fn)
        for ind, (din, dout) in enumerate(reversed(self.in_out)):
            setattr(self, f"ups_{ind}_block1", ResnetBlock(dout * 2, din, emb_dim, g, dt, fn))
            setattr(self, f"ups_{ind}_block2", ResnetBlock(din, din, emb_dim, g, dt, fn))
            setattr(self, f"ups_{ind}_spatial_attn",
                    PreNormResidual(din, SpatialLinearAttention, heads, 32, dt, impl))
            setattr(self, f"ups_{ind}_temporal_attn",
                    PreNormResidual(din, TemporalAttention, heads, attn_dim_head, dt, impl))
            if ind < n - 1:
                setattr(self, f"ups_{ind}_upsample", Upsample(din, use_deconv, dt))
        self.final_block = ResnetBlock(dim * 2, dim, None, g, dt, fn)
        self.final_conv = Dense(dim, 2)
        self.occlusion_block = ResnetBlock(dim * 2, dim, None, g, dt, fn)
        self.occlusion_conv = Dense(dim, 1)

    def forward(self, x, time, cond=None, null_cond_mask=None,
                focus_present_mask=None, fea=None):
        b, f = x.shape[:2]
        n = len(self.in_out)
        x = x.to(self.dtype)
        pos_bias = self.time_rel_pos_bias(f)
        x = self.init_conv(x)
        if fea is not None:
            x = x + self.init_conv_fea(fea.to(self.dtype)).to(x.dtype)
        x = gather_channels(x, self.tp)
        r = x
        # reference quirk: no focus mask for the init temporal attention
        x = self.init_temporal_attn(x, pos_bias=pos_bias)

        # tensor-parallel form: column-parallel, each layer's output columns gathered
        t = sinusoidal_pos_emb(time, self.dim)
        t = gather_channels(F.gelu(column_dense(self.time_mlp_1, t, self.tp)), self.tp)
        t = gather_channels(column_dense(self.time_mlp_2, t, self.tp), self.tp)
        if cond is not None:
            if self.learn_null_cond:
                null_emb = self.null_cond_emb
            else:
                null_emb = torch.zeros(self.cond_dim, device=x.device)
            if null_cond_mask is None:
                null_cond_mask = torch.zeros(b, dtype=torch.bool, device=x.device)
            cond = torch.where(null_cond_mask[:, None], null_emb[None, :], cond)
            t = torch.cat([t, cond.to(t.dtype)], dim=-1)

        hs = []
        for ind in range(n):
            x = getattr(self, f"downs_{ind}_block1")(x, t)
            x = getattr(self, f"downs_{ind}_block2")(x, t)
            x = getattr(self, f"downs_{ind}_spatial_attn")(x)
            x = getattr(self, f"downs_{ind}_temporal_attn")(
                x, pos_bias=pos_bias, focus_present_mask=focus_present_mask)
            hs.append(x)
            if ind < n - 1:
                x = getattr(self, f"downs_{ind}_downsample")(x)

        x = self.mid_block1(x, t)
        x = self.mid_spatial_attn(x)
        x = self.mid_temporal_attn(x, pos_bias=pos_bias, focus_present_mask=focus_present_mask)
        x = self.mid_block2(x, t)

        for ind in range(n):
            x = torch.cat([x, hs.pop()], dim=-1)
            x = getattr(self, f"ups_{ind}_block1")(x, t)
            x = getattr(self, f"ups_{ind}_block2")(x, t)
            x = getattr(self, f"ups_{ind}_spatial_attn")(x)
            x = getattr(self, f"ups_{ind}_temporal_attn")(
                x, pos_bias=pos_bias, focus_present_mask=focus_present_mask)
            if ind < n - 1:
                x = getattr(self, f"ups_{ind}_upsample")(x)

        x = torch.cat([x, r], dim=-1)
        grid = self.final_conv(self.final_block(x))
        if self.use_final_activation:
            grid = torch.tanh(grid)
        conf = self.occlusion_conv(self.occlusion_block(x))
        return torch.cat([grid, conf], dim=-1).float()


# ------------------------------------------------------------------ tensor parallelism


def project_out(dense: Dense, o: torch.Tensor, mesh) -> torch.Tensor:
    """`to_out` of an attention layer; in the tensor-parallel form the
    row-parallel product of this rank's heads in fp32 (the operands rounded
    to the compute dtype, as the one-process product takes them), summed
    over the model group and rounded to the compute dtype, then `+ bias`
    as the one-process `Dense` adds it (`blocks.split_bias`)."""
    if mesh is None:
        return dense(o)
    dt = _compute_dtype(dense.dtype, o)
    inside, after = split_bias(dense.bias, dt)
    out = reduce_from_model(F.linear(o.to(dt).float(), dense.weight.to(dt).float()), mesh)
    if inside is not None:
        out = out + inside
    out = out.to(dt)
    return out if after is None else out + after


def column_dense(dense: Dense, x: torch.Tensor, mesh) -> torch.Tensor:
    """A Dense layer; in the tensor-parallel form one whose weight holds
    this rank's output rows and whose bias is replicated (the time MLPs
    under `UNET_TP_RULES`): this rank's output columns."""
    if mesh is None:
        return dense(x)
    dt = _compute_dtype(dense.dtype, x)
    inside, after = split_bias(model_slice(dense.bias, mesh), dt)
    y = F.linear(copy_to_model(x, mesh).to(dt), dense.weight.to(dt), inside)
    return y if after is None else y + after


# module classes that run on a shard, and their parameters that the rules
# shard (every other parameter stays whole)
_TP_MODULES = (TemporalAttention, SpatialLinearAttention, SpatialAttention, Conv2plus1d, GroupNorm,
               ResnetBlock, Downsample, Upsample, Unet3D)
# replicated parameters used on this rank's channels or heads only: their
# gradients are summed over the model group
_SLICED_REPLICATED = ("norm.weight", "norm.bias", "time_mlp_1.bias", "time_mlp_2.bias",
                      "relative_attention_bias.weight")


def check_tp(size: int, heads: int | None = None, groups: int = 8) -> None:
    """The tensor-parallel form splits the UNet's `groups` GroupNorm groups
    (8 in every configuration) and its `heads` attention heads evenly over
    the model axis."""
    if size < 1 or groups % size or (heads is not None and heads % size):
        what = f"GroupNorm({groups}) groups" + (f" and its {heads} attention heads" if heads else "")
        raise ValueError(f"tp={size}: the port's tensor parallelism splits the UNet's {what} evenly "
                         "over the model axis, so tp must divide them (the JAX package replicates "
                         "a leaf it cannot split; the port does not)")


def shard_unet(unet: Unet3D, mesh) -> Unet3D:
    """Turn a built one-process `Unet3D` into its tensor-parallel form over
    `mesh`'s `model` axis, in place, and return it (a no-op on a mesh of
    one model rank, or for a UNet already sharded on `mesh`). The sharded
    parameters are new `Parameter`s: build an optimizer after it.

    Every rank of the model group first takes the first rank's weights;
    then each parameter that `UNET_TP_RULES` shards is cut to this rank's
    slice (`shard_variables`: q|k|v of its heads, scale|shift of its
    channels, else contiguous), under the same name, so that
    `gather_variables(unet.state_dict(), mesh, unet.tp_shapes)` is the
    one-process state.
    The modules then run column-parallel `to_qkv` and FiLM `mlp`,
    row-parallel `to_out` (one fp32 all-reduce per attention layer, the
    residual and bias added once after it), output-channel-sharded convs
    with GroupNorm, FiLM and SiLU on the rank's channels and a channel
    gather where the next layer needs every channel. Each sharded parameter
    gets `tp_sharded = True`, each replicated one that a rank uses only on
    its slice `tp_partial_grad = True` (its gradient is summed over the
    model group; `train/dm_trainer.py`)."""
    if mesh.model_size == 1 or unet.tp is mesh:
        return unet
    if unet.tp is not None:
        raise ValueError("shard_unet: the UNet is already sharded on another mesh")
    heads = unet.time_rel_pos_bias.relative_attention_bias.weight.shape[1]
    for groups in {m.groups for m in unet.modules() if isinstance(m, GroupNorm)}:
        check_tp(mesh.model_size, heads, groups)
    replicate(unet, mesh, axis="model")
    unet.tp_shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    named = dict(unet.named_parameters())
    shards = shard_variables({k: p.detach() for k, p in named.items()}, mesh)
    for name, p in named.items():
        sharded = shards[name].shape != p.shape
        if sharded:  # a new Parameter (no autograd node of the whole one carries over)
            owner, _, leaf = name.rpartition(".")
            p = nn.Parameter(shards[name].clone(), requires_grad=p.requires_grad)
            setattr(unet.get_submodule(owner), leaf, p)
        p.tp_sharded = sharded
        p.tp_partial_grad = not sharded and name.endswith(_SLICED_REPLICATED)
    # every weight of a layer that runs on a shard must be split by the rules
    for mname, m in unet.named_modules():
        split = isinstance(m, (Conv2d, Dense)) or isinstance(m, Upsample) and m.use_deconv
        if split and not m.weight.tp_sharded and not mname.endswith(("final_conv", "occlusion_conv")):
            raise ValueError(f"shard_unet: {mname} is not split by UNET_TP_RULES at tp={mesh.model_size}")
    for m in unet.modules():
        if isinstance(m, _TP_MODULES):
            m.tp = mesh
        if isinstance(m, (TemporalAttention, SpatialLinearAttention, SpatialAttention)):
            m.heads //= mesh.model_size
    unet.tp = mesh
    return unet


def tp_parameters(unet: nn.Module) -> tuple[list, list, list]:
    """`(sharded, partial, whole)`: the trainable parameters of a UNet in
    its tensor-parallel form by kind (all `whole` on one process)."""
    out = ([], [], [])
    for p in unet.parameters():
        if p.requires_grad:
            kind = 0 if getattr(p, "tp_sharded", False) else 1 if getattr(p, "tp_partial_grad", False) else 2
            out[kind].append(p)
    return out

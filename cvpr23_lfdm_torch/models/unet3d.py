"""Conditional 3D UNet, the denoiser (counterpart of
`cvpr23_lfdm_tpu/models/unet3d.py::Unet3D`), in a serving and a training
form chosen by `temporal_attn_impl`, named as in the JAX package:

* `"pallas3"`, the serving form (forward-only): every PreNorm
  temporal-attention layer is one :func:`ops.attention.fused_temporal_layer`
  and every PreNorm linear attention layer one
  :func:`ops.attention.fused_spatial_linear_layer`.
* `"pallas2"`, the training form (differentiable): `x + attn(LN(x))` with
  the temporal attention as `to_qkv` ->
  :func:`ops.attention.headpacked_temporal_attention` (forward and backward
  kernels) -> `to_out`, and the linear attention unfused in plain PyTorch.

Both forms have the same parameters, so one state dict loads into either.
:func:`resolve_attn_impl` maps a config value to a form as the JAX CLIs'
`resolve_attn_impl` does on a TPU: serving gets `pallas3`, training
`pallas2`, unless the config names one of the two.

Layout `[B, F, H, W, C]`; the "(1, k, k)" pseudo-3D convs are 2D convs over
the folded `B*F` batch. Module and parameter names follow
the JAX variable tree. Parameters stay fp32; `dtype` is the compute dtype
(bf16 for serving), with GroupNorm/LayerNorm statistics and softmax in fp32
and the time/condition MLP and output heads in fp32, as in the JAX model.

Reference quirks kept: the init temporal attention gets no focus mask, and
the linear and mid attention use dim_head 32 whatever `attn_dim_head` is.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d, Dense
from cvpr23_lfdm_torch.ops import attention as attn_ops


ATTN_IMPLS = ("pallas2", "pallas3")


def resolve_attn_impl(value: str, training: bool) -> str:
    """The UNet form for a config's `temporal_attn_impl`: `pallas2` or
    `pallas3` (an `_interpret` suffix is dropped) as named; any other value
    (`xla`, `auto`, ...: the port has no einsum form) lets the entry point
    choose: `pallas2` for training, `pallas3` for serving."""
    for impl in ATTN_IMPLS:
        if value.startswith(impl):
            return impl
    return "pallas2" if training else "pallas3"


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
        pos = np.arange(n, dtype=np.int64)
        buckets = _rel_pos_bucket(pos[None, :] - pos[:, None], self.num_buckets, self.max_distance)
        idx = torch.from_numpy(buckets).to(self.relative_attention_bias.weight.device)
        return self.relative_attention_bias(idx).permute(2, 0, 1)


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


class TemporalAttention(nn.Module):
    """Attention over the frame axis, batched over pixels.

    `impl="pallas3"` (serving): the whole PreNorm layer (LN + qkv + rotary +
    attention + out-proj + residual) is one forward-only fused kernel and
    `forward` takes the raw `x` with `prenorm_gamma`. `impl="pallas2"`
    (training): `to_qkv` -> differentiable head-packed attention kernel ->
    `to_out` on the normalized input."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "pallas3"):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.fused = impl == "pallas3"
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, 3 * hidden, bias=False, dtype=dtype)
        self.to_out = Dense(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x, prenorm_gamma=None, pos_bias=None, focus_present_mask=None):
        b, f, h, w, c = x.shape
        cdt = self.dtype
        if pos_bias is None:
            pos_bias = torch.zeros((self.heads, f, f), device=x.device)
        bias_flat = attn_ops.build_bias_flat(pos_bias, b, f, focus_present_mask)
        cos_t, sin_t = attn_ops.rotary_tables(
            f, self.heads, self.dim_head, self.dim_head ** -0.5, cdt, x.device
        )
        if not self.fused:
            qkv = self.to_qkv(x).reshape(b, f, h * w, -1)
            out = attn_ops.headpacked_temporal_attention(
                qkv, bias_flat, cos_t, sin_t, self.heads, self.dim_head)
            return self.to_out(out.reshape(b, f, h, w, -1))
        out = attn_ops.fused_temporal_layer(
            x.reshape(b, f, h * w, c).to(cdt).contiguous(),
            prenorm_gamma.float().contiguous(),
            self.to_qkv.weight.to(cdt).t().contiguous(),
            self.to_out.weight.to(cdt).t().contiguous(),
            bias_flat, cos_t, sin_t, self.heads, self.dim_head,
        )
        return out.reshape(b, f, h, w, c).to(x.dtype)


class SpatialLinearAttention(nn.Module):
    """Softmax-kernel linear attention per frame: one forward-only fused
    PreNorm layer (`impl="pallas3"`), or its differentiable unfused form in
    plain PyTorch on the normalized input (training; it reaches no kernel)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "pallas3"):
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
        return self.to_out(out.reshape(b, f, h, w, heads * d))

    def forward(self, x, prenorm_gamma=None):
        if not self.fused:
            return self._unfused(x)
        b, f, h, w, c = x.shape
        cdt = self.dtype
        out = attn_ops.fused_spatial_linear_layer(
            x.reshape(b, f, h * w, c).to(cdt).contiguous(),
            prenorm_gamma.float().contiguous(),
            self.to_qkv.weight.to(cdt).t().contiguous(),
            self.to_out.weight.to(cdt).t().contiguous(),
            self.to_out.bias.float().contiguous(),
            self.heads, self.dim_head,
        )
        return out.reshape(b, f, h, w, c).to(x.dtype)


class SpatialAttention(nn.Module):
    """Full attention over pixels, batched over frames (mid block only)."""

    fused = False

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=torch.float32,
                 impl: str = "pallas3"):
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
        return self.to_out(out)


class PreNormResidual(nn.Module):
    """x + attn(LN(x)); fused attention layers take the LN gamma instead."""

    def __init__(self, dim: int, attn_cls, heads: int, dim_head: int, dtype=torch.float32,
                 impl: str = "pallas3"):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.attn = attn_cls(dim, heads, dim_head, dtype=dtype, impl=impl)

    def forward(self, x, **kwargs):
        if self.attn.fused:
            return self.attn(x, prenorm_gamma=self.norm.gamma, **kwargs)
        return x + self.attn(self.norm(x), **kwargs)


class Conv2plus1d(nn.Module):
    """(1, k, k) pseudo-3D conv as a frame-folded 2D conv."""

    def __init__(self, cin: int, cout: int, k: int, dtype=None, bias: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, bias=bias, dtype=dtype)

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = self.conv(x.reshape(b * f, h, w, c))
        return y.reshape(b, f, h, w, -1)


class GroupNorm(nn.Module):
    """GroupNorm over (F, H, W, C/G) per batch entry: fp32 statistics
    (var = E[x²]−mean², clipped at 0), fp32 normalize, result in `dtype`."""

    def __init__(self, c: int, groups: int = 8, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        shape = x.shape
        xf = x.float().reshape(shape[0], -1, self.groups, shape[-1] // self.groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(shape) * self.weight + self.bias
        return y.to(self.dtype)


class Block(nn.Module):
    """conv(1,3,3) -> GroupNorm(8) -> FiLM -> SiLU."""

    def __init__(self, cin: int, cout: int, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = Conv2plus1d(cin, cout, 3, dtype=dtype)
        self.norm = GroupNorm(cout, groups, dtype=dtype)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0).to(self.dtype) + shift.to(self.dtype)
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two FiLM blocks + 1x1x1 residual conv (a Dense on channel-last)."""

    def __init__(self, cin: int, cout: int, cond_dim: int | None, groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = Dense(cond_dim, 2 * cout, dtype=dtype) if cond_dim else None
        self.block1 = Block(cin, cout, groups, dtype)
        self.block2 = Block(cout, cout, groups, dtype)
        self.res_conv = Dense(cin, cout, dtype=dtype) if cin != cout else None

    def forward(self, x, cond_emb=None):
        scale_shift = None
        if cond_emb is not None:
            t = self.mlp(F.silu(cond_emb))[:, None, None, None, :]
            scale_shift = t.chunk(2, dim=-1)
        h = self.block2(self.block1(x, scale_shift))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return (h + x).to(self.dtype)


class Downsample(nn.Module):
    """(1,4,4)/(1,2,2) strided conv."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim, dim, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        b, f, h, w, c = x.shape
        return self.conv(x.reshape(b * f, h, w, c)).reshape(b, f, h // 2, w // 2, -1)


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

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = x.reshape(b * f, h, w, c)
        if self.use_deconv:
            dt = self.dtype
            y = F.conv_transpose2d(
                y.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
                stride=2, padding=1,
            ).permute(0, 2, 3, 1)
        else:
            y = self.conv(y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return y.reshape(b, f, 2 * h, 2 * w, -1)


class Unet3D(nn.Module):
    """Input `[B, F, H, W, 3]` noisy latent (+ `fea [B, Ff, H, W, Cf]`,
    Ff in {1, F}), output `[B, F, H, W, 3]` fp32 (2 flow + 1 conf)."""

    def __init__(self, dim: int = 64, cond_dim: int = 768, dim_mults=(1, 2, 4, 8),
                 attn_heads: int = 8, attn_dim_head: int = 32, learn_null_cond: bool = False,
                 use_deconv: bool = True, use_final_activation: bool = False,
                 dtype=torch.float32, fea_channels: int = 256,
                 temporal_attn_impl: str = "pallas3"):
        super().__init__()
        if temporal_attn_impl not in ATTN_IMPLS:
            raise ValueError(f"temporal_attn_impl {temporal_attn_impl!r} not in {ATTN_IMPLS}")
        impl = self.temporal_attn_impl = temporal_attn_impl
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
            setattr(self, f"downs_{ind}_block1", ResnetBlock(din, dout, emb_dim, g, dt))
            setattr(self, f"downs_{ind}_block2", ResnetBlock(dout, dout, emb_dim, g, dt))
            setattr(self, f"downs_{ind}_spatial_attn",
                    PreNormResidual(dout, SpatialLinearAttention, heads, 32, dt, impl))
            setattr(self, f"downs_{ind}_temporal_attn",
                    PreNormResidual(dout, TemporalAttention, heads, attn_dim_head, dt, impl))
            if ind < n - 1:
                setattr(self, f"downs_{ind}_downsample", Downsample(dout, dt))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, emb_dim, g, dt)
        self.mid_spatial_attn = PreNormResidual(mid, SpatialAttention, heads, 32, dt, impl)
        self.mid_temporal_attn = PreNormResidual(mid, TemporalAttention, heads, attn_dim_head, dt, impl)
        self.mid_block2 = ResnetBlock(mid, mid, emb_dim, g, dt)
        for ind, (din, dout) in enumerate(reversed(self.in_out)):
            setattr(self, f"ups_{ind}_block1", ResnetBlock(dout * 2, din, emb_dim, g, dt))
            setattr(self, f"ups_{ind}_block2", ResnetBlock(din, din, emb_dim, g, dt))
            setattr(self, f"ups_{ind}_spatial_attn",
                    PreNormResidual(din, SpatialLinearAttention, heads, 32, dt, impl))
            setattr(self, f"ups_{ind}_temporal_attn",
                    PreNormResidual(din, TemporalAttention, heads, attn_dim_head, dt, impl))
            if ind < n - 1:
                setattr(self, f"ups_{ind}_upsample", Upsample(din, use_deconv, dt))
        self.final_block = ResnetBlock(dim * 2, dim, None, g, dt)
        self.final_conv = Dense(dim, 2)
        self.occlusion_block = ResnetBlock(dim * 2, dim, None, g, dt)
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
        r = x
        # reference quirk: no focus mask for the init temporal attention
        x = self.init_temporal_attn(x, pos_bias=pos_bias)

        t = self.time_mlp_2(F.gelu(self.time_mlp_1(sinusoidal_pos_emb(time, self.dim))))
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

"""The conditional 3D UNet of the reference, fp32: a frozen copy of the
port's plain `xla` form (`models/unet3d.py`: einsum temporal attention with
rotary and the T5 relative-position bias, unfused linear attention, full
attention in the middle) without the kernel forms, the fused norm, the
tensor-parallel form and the compute dtype. Parameter names are the
port's. Layout `[B, F, H, W, C]`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv2d, Dense
from portbench.reference.precision import q


def sinusoidal_pos_emb(t, dim):
    half = dim // 2
    freqs = torch.exp(-(math.log(10000.0) / (half - 1)) * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rel_pos_bucket(n: int, num_buckets: int = 32, max_distance: int = 32) -> np.ndarray:
    """T5 bucketing of `j - i` for an `[n, n]` grid."""
    pos = np.arange(n, dtype=np.int64)
    rel = pos[None, :] - pos[:, None]
    ret = np.zeros_like(rel)
    m = -rel
    num_buckets //= 2
    ret += (m < 0).astype(np.int64) * num_buckets
    m = np.abs(m)
    max_exact = num_buckets // 2
    val_large = max_exact + (np.log(np.maximum(m, 1).astype(np.float64) / max_exact)
                             / math.log(max_distance / max_exact) * (num_buckets - max_exact)).astype(np.int64)
    return ret + np.where(m < max_exact, m, np.minimum(val_large, num_buckets - 1))


def rotate_pairs(x):
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def rotary(d: int, n: int, device):
    """Interleaved rotary `cos`, `sin` `[n, d]` over the first min(32, d) channels."""
    rot = min(32, d)
    freqs = 1.0 / (10000.0 ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    ang = np.repeat(np.outer(np.arange(n, dtype=np.float64), freqs), 2, axis=-1)
    cos, sin = np.ones((n, d)), np.zeros((n, d))
    cos[:, :rot], sin[:, :rot] = np.cos(ang), np.sin(ang)
    return (torch.from_numpy(cos.astype(np.float32)).to(device),
            torch.from_numpy(sin.astype(np.float32)).to(device))


class RelativePositionBias(nn.Module):
    def __init__(self, heads=8, num_buckets=32, max_distance=32):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n):
        idx = torch.from_numpy(rel_pos_bucket(n, self.num_buckets, self.max_distance))
        return self.relative_attention_bias(idx.to(self.relative_attention_bias.weight.device)).permute(2, 0, 1)


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return q((x - mean) / torch.sqrt(var + self.eps) * self.gamma)


class TemporalAttention(nn.Module):
    """Softmax attention over frames, per pixel: rotary on q and k, the
    relative-position bias, an optional focus mask."""

    def __init__(self, dim, heads=8, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Dense(dim, 3 * heads * dim_head, bias=False)
        self.to_out = Dense(heads * dim_head, dim, bias=False)

    def forward(self, x, pos_bias=None, focus_present_mask=None):
        b, f, h, w, _ = x.shape
        heads, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, heads, d)
        q_, k, v = qkv[..., 0, :, :] * d ** -0.5, qkv[..., 1, :, :], qkv[..., 2, :, :]
        cos, sin = (t[None, :, None, None, :] for t in rotary(d, f, x.device))
        q_ = q_ * cos + rotate_pairs(q_) * sin
        k = k * cos + rotate_pairs(k) * sin
        sim = torch.einsum("bixhd,bjxhd->bxhij", q(q_), q(k))
        if pos_bias is not None:
            sim = sim + pos_bias[None, None]
        if focus_present_mask is not None:
            keep = torch.eye(f, dtype=torch.bool, device=x.device) | ~focus_present_mask[:, None, None, None, None]
            sim = torch.where(keep, sim, torch.finfo(torch.float32).min)
        attn = torch.softmax(sim - sim.amax(dim=-1, keepdim=True).detach(), dim=-1)
        out = torch.einsum("bxhij,bjxhd->bixhd", q(attn), q(v))
        return self.to_out(out.reshape(b, f, h, w, heads * d))


class SpatialLinearAttention(nn.Module):
    """Softmax-kernel linear attention over the pixels of each frame."""

    def __init__(self, dim, heads=8, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Dense(dim, 3 * heads * dim_head, bias=False)
        self.to_out = Dense(heads * dim_head, dim, bias=True)

    def forward(self, x):
        b, f, h, w, _ = x.shape
        heads, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, heads, d)
        q_, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        q_ = torch.softmax(q_, dim=-1) * d ** -0.5
        k = torch.softmax(k, dim=2)
        context = torch.einsum("bfnhd,bfnhe->bfhde", q(k), q(v))
        out = torch.einsum("bfhde,bfnhd->bfnhe", q(context), q(q_))
        return self.to_out(out.reshape(b, f, h, w, heads * d))


class SpatialAttention(nn.Module):
    """Full attention over pixels, per frame (the middle block)."""

    def __init__(self, dim, heads=8, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Dense(dim, 3 * heads * dim_head, bias=False)
        self.to_out = Dense(heads * dim_head, dim, bias=False)

    def forward(self, x):
        b, f, h, w, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, f, h * w, 3, self.heads, self.dim_head)
        q_, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
        sim = torch.einsum("bfhid,bfhjd->bfhij", q(q_ * self.dim_head ** -0.5), q(k))
        out = torch.einsum("bfhij,bfhjd->bfhid", q(torch.softmax(sim, dim=-1)), q(v))
        return self.to_out(out.permute(0, 1, 3, 2, 4).reshape(b, f, h, w, -1))


class PreNormResidual(nn.Module):
    def __init__(self, dim, attn_cls, heads, dim_head):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.attn = attn_cls(dim, heads, dim_head)

    def forward(self, x, **kwargs):
        return q(x + self.attn(self.norm(x), **kwargs))


class Conv2plus1d(nn.Module):
    def __init__(self, cin, cout, k, bias=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, bias=bias)

    def forward(self, x):
        b, f, h, w, c = x.shape
        return self.conv(x.reshape(b * f, h, w, c)).reshape(b, f, h, w, -1)


class GroupNorm(nn.Module):
    def __init__(self, c, groups=8, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        shape = x.shape
        xf = x.reshape(shape[0], -1, self.groups, shape[-1] // self.groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        return q(((xf - mean) * torch.rsqrt(var + self.eps)).reshape(shape) * self.weight + self.bias)


class Block(nn.Module):
    def __init__(self, cin, cout, groups=8):
        super().__init__()
        self.proj = Conv2plus1d(cin, cout, 3)
        self.norm = GroupNorm(cout, groups)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            x = x * (scale_shift[0] + 1.0) + scale_shift[1]
        return q(F.silu(x))


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, cond_dim, groups=8):
        super().__init__()
        self.mlp = Dense(cond_dim, 2 * cout) if cond_dim else None
        self.block1 = Block(cin, cout, groups)
        self.block2 = Block(cout, cout, groups)
        self.res_conv = Dense(cin, cout) if cin != cout else None

    def forward(self, x, cond_emb=None):
        scale_shift = None
        if cond_emb is not None:
            scale_shift = self.mlp(F.silu(cond_emb))[:, None, None, None, :].chunk(2, dim=-1)
        h = self.block2(self.block1(x, scale_shift))
        return q(h + (x if self.res_conv is None else self.res_conv(x)))


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv2d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x):
        b, f, h, w, c = x.shape
        return self.conv(x.reshape(b * f, h, w, c)).reshape(b, f, h // 2, w // 2, -1)


class Upsample(nn.Module):
    """ConvTranspose (4, stride 2, pad 1) with `use_deconv`, else nearest-2x + conv."""

    def __init__(self, dim, use_deconv=True):
        super().__init__()
        self.use_deconv = use_deconv
        if use_deconv:
            self.weight = nn.Parameter(torch.zeros(dim, dim, 4, 4))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.conv = Conv2d(dim, dim, 3)

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = x.reshape(b * f, h, w, c)
        if self.use_deconv:
            y = q(F.conv_transpose2d(q(y.permute(0, 3, 1, 2)), q(self.weight), self.bias,
                                     stride=2, padding=1).permute(0, 2, 3, 1))
        else:
            y = self.conv(y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return y.reshape(b, f, 2 * h, 2 * w, -1)


class Unet3D(nn.Module):
    """`[B, F, H, W, 3]` noisy latent (+ `fea [B, 1, H, W, Cf]`) -> `[B, F, H, W, 3]`."""

    def __init__(self, dim=64, cond_dim=768, dim_mults=(1, 2, 4, 8), attn_heads=8, attn_dim_head=32,
                 learn_null_cond=False, use_deconv=True, use_final_activation=False, fea_channels=256):
        super().__init__()
        self.dim, self.cond_dim = dim, cond_dim
        self.learn_null_cond, self.use_final_activation = learn_null_cond, use_final_activation
        heads, g = attn_heads, 8
        self.time_rel_pos_bias = RelativePositionBias(heads=heads, max_distance=32)
        self.init_conv = Conv2plus1d(3, dim, 7)
        self.init_conv_fea = Conv2plus1d(fea_channels, dim, 7, bias=False)
        self.init_temporal_attn = PreNormResidual(dim, TemporalAttention, heads, attn_dim_head)
        time_dim = dim * 4
        self.time_mlp_1 = Dense(dim, time_dim)
        self.time_mlp_2 = Dense(time_dim, time_dim)
        if learn_null_cond:
            self.null_cond_emb = nn.Parameter(torch.zeros(cond_dim))
        emb = time_dim + cond_dim
        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        n = len(self.in_out)
        for i, (din, dout) in enumerate(self.in_out):
            setattr(self, f"downs_{i}_block1", ResnetBlock(din, dout, emb, g))
            setattr(self, f"downs_{i}_block2", ResnetBlock(dout, dout, emb, g))
            setattr(self, f"downs_{i}_spatial_attn", PreNormResidual(dout, SpatialLinearAttention, heads, 32))
            setattr(self, f"downs_{i}_temporal_attn", PreNormResidual(dout, TemporalAttention, heads, attn_dim_head))
            if i < n - 1:
                setattr(self, f"downs_{i}_downsample", Downsample(dout))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, emb, g)
        self.mid_spatial_attn = PreNormResidual(mid, SpatialAttention, heads, 32)
        self.mid_temporal_attn = PreNormResidual(mid, TemporalAttention, heads, attn_dim_head)
        self.mid_block2 = ResnetBlock(mid, mid, emb, g)
        for i, (din, dout) in enumerate(reversed(self.in_out)):
            setattr(self, f"ups_{i}_block1", ResnetBlock(dout * 2, din, emb, g))
            setattr(self, f"ups_{i}_block2", ResnetBlock(din, din, emb, g))
            setattr(self, f"ups_{i}_spatial_attn", PreNormResidual(din, SpatialLinearAttention, heads, 32))
            setattr(self, f"ups_{i}_temporal_attn", PreNormResidual(din, TemporalAttention, heads, attn_dim_head))
            if i < n - 1:
                setattr(self, f"ups_{i}_upsample", Upsample(din, use_deconv))
        self.final_block = ResnetBlock(dim * 2, dim, None, g)
        self.final_conv = Dense(dim, 2)
        self.occlusion_block = ResnetBlock(dim * 2, dim, None, g)
        self.occlusion_conv = Dense(dim, 1)

    def forward(self, x, time, cond=None, null_cond_mask=None, fea=None):
        b, f = x.shape[:2]
        n = len(self.in_out)
        pos_bias = self.time_rel_pos_bias(f)
        x = self.init_conv(x.float())
        if fea is not None:
            x = x + self.init_conv_fea(fea.float())
        r = x
        x = self.init_temporal_attn(x, pos_bias=pos_bias)
        t = self.time_mlp_2(F.gelu(self.time_mlp_1(sinusoidal_pos_emb(time, self.dim))))
        if cond is not None:
            null = self.null_cond_emb if self.learn_null_cond else torch.zeros(self.cond_dim, device=x.device)
            if null_cond_mask is None:
                null_cond_mask = torch.zeros(b, dtype=torch.bool, device=x.device)
            t = torch.cat([t, torch.where(null_cond_mask[:, None], null[None, :], cond.float())], dim=-1)
        hs = []
        for i in range(n):
            x = getattr(self, f"downs_{i}_block1")(x, t)
            x = getattr(self, f"downs_{i}_block2")(x, t)
            x = getattr(self, f"downs_{i}_spatial_attn")(x)
            x = getattr(self, f"downs_{i}_temporal_attn")(x, pos_bias=pos_bias)
            hs.append(x)
            if i < n - 1:
                x = getattr(self, f"downs_{i}_downsample")(x)
        x = self.mid_block1(x, t)
        x = self.mid_spatial_attn(x)
        x = self.mid_temporal_attn(x, pos_bias=pos_bias)
        x = self.mid_block2(x, t)
        for i in range(n):
            x = torch.cat([x, hs.pop()], dim=-1)
            x = getattr(self, f"ups_{i}_block1")(x, t)
            x = getattr(self, f"ups_{i}_block2")(x, t)
            x = getattr(self, f"ups_{i}_spatial_attn")(x)
            x = getattr(self, f"ups_{i}_temporal_attn")(x, pos_bias=pos_bias)
            if i < n - 1:
                x = getattr(self, f"ups_{i}_upsample")(x)
        x = torch.cat([x, r], dim=-1)
        grid = self.final_conv(self.final_block(x))
        if self.use_final_activation:
            grid = torch.tanh(grid)
        return torch.cat([grid, self.occlusion_conv(self.occlusion_block(x))], dim=-1)

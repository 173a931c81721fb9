"""Plain fp32 building blocks of the reference, channel-last `[N, H, W, C]`.

A frozen copy of the port's plain versions (its `models/blocks.py`,
`ops/{ties,grid,eig2x2,antialias,resize}.py`) with every kernel path, band
mode, process group and compute dtype taken out: fp32 throughout, every
product's operands and every stored activation (a product's output, a
norm's, a residual sum) through `precision.q`. Parameter names are the port's, so one
state dict loads into both. The warps are `F.grid_sample` (bilinear, zeros
padding, `align_corners=False`), the semantics of the port's warp kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import q

# ------------------------------------------------------------------ ties


def maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """`jnp.maximum(x, v)`: half the gradient to each side at a tie."""
    return torch.maximum(x, torch.full_like(x, v))


# ------------------------------------------------------------------ layers


class Conv2d(nn.Module):
    """2D conv on `[N, H, W, C]`, weight OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = F.conv2d(q(x.float().permute(0, 3, 1, 2)), q(self.weight), self.bias,
                     stride=self.stride, padding=self.padding)
        return q(y.permute(0, 2, 3, 1))


class Dense(nn.Module):
    """`x @ W^T + b`, weight `[out, in]`."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return q(F.linear(q(x.float()), q(self.weight), self.bias))


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis (eps 1e-5) with its running
    statistics: the LFAE's nets run in eval mode in every entry here."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        x = x.float()
        mean, var = self.running_mean, self.running_var
        return q((x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias)


def avg_pool_2x2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def resize_bilinear(x, size):
    """`F.interpolate(bilinear, align_corners=False)` on `[B, H, W, C]`."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class SameBlock2d(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = Conv2d(cin, cout, k)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock2d(SameBlock2d):
    def forward(self, x):
        return avg_pool_2x2(super().forward(x))


class UpBlock2d(SameBlock2d):
    def forward(self, x):
        return super().forward(upsample_nearest_2x(x))


class ResBlock2d(nn.Module):
    def __init__(self, c, k=3):
        super().__init__()
        self.norm1 = BatchNorm(c)
        self.conv1 = Conv2d(c, c, k)
        self.norm2 = BatchNorm(c)
        self.conv2 = Conv2d(c, c, k)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        return q(self.conv2(F.relu(self.norm2(out))) + x)


class Encoder(nn.Module):
    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        self.num_blocks = num_blocks
        cin = in_features
        for i in range(num_blocks):
            cout = min(max_features, block_expansion * (2 ** (i + 1)))
            setattr(self, f"down_{i}", DownBlock2d(cin, cout, 3))
            cin = cout

    def forward(self, x):
        outs = [x]
        for i in range(self.num_blocks):
            outs.append(getattr(self, f"down_{i}")(outs[-1]))
        return outs


class Decoder(nn.Module):
    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        self.num_blocks = num_blocks
        for j, i in enumerate(reversed(range(num_blocks))):
            cin = (1 if i == num_blocks - 1 else 2) * min(max_features, block_expansion * (2 ** (i + 1)))
            cout = min(max_features, block_expansion * (2 ** i))
            setattr(self, f"up_{j}", UpBlock2d(cin, cout, 3))
        self.out_filters = block_expansion + in_features

    def forward(self, feats):
        feats = list(feats)
        out = feats.pop()
        for j in range(self.num_blocks):
            out = torch.cat([getattr(self, f"up_{j}")(out), feats.pop().float()], dim=-1)
        return out


class Hourglass(nn.Module):
    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features)
        self.decoder = Decoder(block_expansion, in_features, num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))


# ------------------------------------------------------------------ grids and warps


def make_coordinate_grid(spatial_size, device=None):
    """`[H, W, 2]` over [-1, 1]^2 (align-corners spacing), last axis (x, y)."""
    h, w = spatial_size
    x = 2.0 * (torch.arange(w, dtype=torch.float32, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=torch.float32, device=device) / (h - 1)) - 1.0
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def grid_sample(image, grid, padding_mode: str = "zeros"):
    """Bilinear sample of `image [B, H, W, C]` at `grid [B, Hg, Wg, 2]`,
    `align_corners=False`, fp32."""
    out = F.grid_sample(image.float().permute(0, 3, 1, 2), grid.float(), mode="bilinear",
                        padding_mode=padding_mode, align_corners=False)
    return out.permute(0, 2, 3, 1)


def inv_2x2(m):
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) * inv_det[..., None, None]


def region2gaussian(center, covar, spatial_size):
    h, w = spatial_size
    grid = make_coordinate_grid(spatial_size, device=center.device)
    lead = center.shape[:-1]
    diff = grid.reshape((1,) * len(lead) + (h, w, 2)) - center.reshape(lead + (1, 1, 2))
    if isinstance(covar, (float, int)):
        under_exp = (diff ** 2).sum(dim=-1) / covar
    else:
        cinv = inv_2x2(covar).reshape(lead + (1, 1, 2, 2))
        dx, dy = diff[..., 0], diff[..., 1]
        under_exp = (dx * dx * cinv[..., 0, 0] + dx * dy * (cinv[..., 0, 1] + cinv[..., 1, 0])
                     + dy * dy * cinv[..., 1, 1])
    return torch.exp(-0.5 * under_exp)


def to_homogeneous(c):
    return torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)


def from_homogeneous(c):
    return c[..., :2] / c[..., 2:3]


_EPS, _THIN = 1e-12, 1e-3


def _lead_sign(v):
    lead = torch.where(v[..., 0].abs() >= v[..., 1].abs(), v[..., 0], v[..., 1])
    return torch.where(lead < 0, -1.0, 1.0).to(v.dtype)[..., None]


def sqrt_psd_2x2(covar):
    """`U sqrt(S)` of a symmetric PSD 2x2 (S descending, each eigenvector's
    largest component non-negative; a thin matrix's smaller eigenvalue as
    det / s1 with the determinant in float64)."""
    a = covar[..., 0, 0]
    b = 0.5 * (covar[..., 0, 1] + covar[..., 1, 0])
    c = covar[..., 1, 1]
    half_tr = 0.5 * (a + c)
    rad = torch.sqrt(maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    s1, s2 = half_tr + rad, half_tr - rad
    thin = s2 < _THIN * s1
    det = a.double() * c.double() - b.double() * b.double()
    s2 = torch.where(thin, (det / torch.where(thin, s1, 1.0).double()).to(s1.dtype), s2)
    v1a = torch.stack([b, s1 - a], dim=-1)
    v1b = torch.stack([s1 - c, b], dim=-1)
    v1 = torch.where((v1a * v1a).sum(-1, keepdim=True) >= (v1b * v1b).sum(-1, keepdim=True), v1a, v1b)
    e1 = torch.zeros_like(v1)
    e1[..., 0] = 1.0
    norm1 = torch.sqrt((v1 * v1).sum(dim=-1, keepdim=True))
    v1 = torch.where(norm1 > _EPS, v1 / maximum(norm1, _EPS), e1)
    v1 = v1 * _lead_sign(v1)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    v2 = v2 * _lead_sign(v2)
    u = torch.stack([v1, v2], dim=-1)
    s = torch.stack([s1, s2], dim=-1)
    return u * torch.sqrt(maximum(s, 0.0))[..., None, :]


class AntiAliasDownsample:
    """Gaussian blur (two 1-D depthwise convs, zero padding) then stride:
    sigma = (1/scale - 1)/2, 2*round(4 sigma) + 1 taps."""

    def __init__(self, scale: float):
        self.scale = scale
        if scale != 1.0:
            sigma = (1.0 / scale - 1.0) / 2.0
            ksize = 2 * round(sigma * 4) + 1
            xs = np.arange(ksize, dtype=np.float64)
            k = np.exp(-((xs - (ksize - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
            self.kernel = (k / k.sum()).astype(np.float32)
            self.ka = ksize // 2
            self.kb = self.ka - 1 if ksize % 2 == 0 else self.ka
            self.stride = int(round(1.0 / scale))

    def __call__(self, x):
        if self.scale == 1.0:
            return x
        c = x.shape[-1]
        k = torch.from_numpy(self.kernel).to(device=x.device, dtype=torch.float32)
        y = x.float().permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(y, (0, 0, self.ka, self.kb)), k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        y = F.conv2d(F.pad(y, (self.ka, self.kb, 0, 0)), k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
        return y[:, :, :: self.stride, :: self.stride].permute(0, 2, 3, 1)

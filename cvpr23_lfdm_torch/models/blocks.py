"""LFAE conv building blocks, channel-last (counterpart of
`cvpr23_lfdm_tpu/models/blocks.py`), plus the channel-last conv and dense
layers the port's models share.

Parameters are named after the JAX package's variable paths so the weight
bridge (`utils/bench_ckpt.py::from_jax_params`) is mechanical. Every layer
takes a compute `dtype` (None: fp32, the promotion of fp32 parameters with
the input): parameters stay fp32 and are cast at use, as flax does.
BatchNorm is eval-mode only (serving), with fp32 statistics and output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.ops.resize import avg_pool_2x2, upsample_nearest_2x


def _compute_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


class Conv2d(nn.Module):
    """2D conv on `[N, H, W, C]`; weight OIHW (a flax HWIO kernel transposed).

    The input is viewed as NCHW with channels-last strides, so cuDNN runs an
    NHWC convolution and no copy is made on the card."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True, dtype=None):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        nn.init.normal_(self.weight, std=(cin * k * k) ** -0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        y = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            stride=self.stride, padding=self.padding,
        )
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """`nn.Linear` (weight `[out, in]`, a flax Dense kernel transposed) with
    a compute dtype."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype=None):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        return F.linear(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
        )


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (eps 1e-5), fp32 in and out."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * inv + self.bias


class SameBlock2d(nn.Module):
    """conv -> BN -> ReLU, resolution preserved."""

    def __init__(self, cin: int, cout: int, k: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(cin, cout, k, dtype=dtype)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return x.to(self.dtype or x.dtype)


class DownBlock2d(SameBlock2d):
    """conv -> BN -> ReLU -> avgpool2."""

    def forward(self, x):
        return avg_pool_2x2(super().forward(x))


class UpBlock2d(SameBlock2d):
    """nearest-2x -> conv -> BN -> ReLU."""

    def forward(self, x):
        return super().forward(upsample_nearest_2x(x))


class ResBlock2d(nn.Module):
    """BN -> ReLU -> conv -> BN -> ReLU -> conv -> +x."""

    def __init__(self, c: int, k: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = BatchNorm(c)
        self.conv1 = Conv2d(c, c, k, dtype=dtype)
        self.norm2 = BatchNorm(c)
        self.conv2 = Conv2d(c, c, k, dtype=dtype)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return (out + x).to(self.dtype or x.dtype)


class Encoder(nn.Module):
    """Hourglass encoder: a stack of DownBlocks; returns all scales (input
    included), coarsest last."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        self.num_blocks = num_blocks
        cin = in_features
        for i in range(num_blocks):
            cout = min(max_features, block_expansion * (2 ** (i + 1)))
            setattr(self, f"down_{i}", DownBlock2d(cin, cout, 3, dtype=dtype))
            cin = cout

    def forward(self, x) -> list[torch.Tensor]:
        outs = [x]
        for i in range(self.num_blocks):
            outs.append(getattr(self, f"down_{i}")(outs[-1]))
        return outs


class Decoder(nn.Module):
    """Hourglass decoder with skip concatenation; `out_filters` output
    channels (`block_expansion + in_features`)."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        self.num_blocks = num_blocks
        for j, i in enumerate(reversed(range(num_blocks))):
            cin = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * (2 ** (i + 1)))
            cout = min(max_features, block_expansion * (2 ** i))
            setattr(self, f"up_{j}", UpBlock2d(cin, cout, 3, dtype=dtype))
        self.out_filters = block_expansion + in_features

    def forward(self, feats) -> torch.Tensor:
        feats = list(feats)
        out = feats.pop()
        for j in range(self.num_blocks):
            out = getattr(self, f"up_{j}")(out)
            skip = feats.pop()
            dt = torch.promote_types(out.dtype, skip.dtype)
            out = torch.cat([out.to(dt), skip.to(dt)], dim=-1)
        return out


class Hourglass(nn.Module):
    """Encoder + decoder."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features, dtype)
        self.decoder = Decoder(block_expansion, in_features, num_blocks, max_features, dtype)
        self.out_filters = self.decoder.out_filters

    def forward(self, x) -> torch.Tensor:
        return self.decoder(self.encoder(x))

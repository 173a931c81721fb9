"""LFAE conv building blocks, channel-last (counterpart of
`cvpr23_lfdm_tpu/models/blocks.py`), plus the channel-last conv and dense
layers the port's models share.

Parameters are named after the JAX package's variable paths so the weight
bridge (`utils/bench_ckpt.py::from_jax_params`) is mechanical. Every layer
takes a compute `dtype` (None: fp32, the promotion of fp32 parameters with
the input): parameters stay fp32 and are cast at use, as flax does.
BatchNorm follows the module's `train`/`eval` mode, the JAX package's
`train` argument: batch statistics in train mode (as flax computes them),
the running statistics in eval mode; fp32 statistics and output. It is
built in eval mode, as are the LFAE modules, the JAX `train=False` default;
`.train()` turns training on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.ops import ties
from cvpr23_lfdm_torch.ops.resize import avg_pool_2x2, upsample_nearest_2x


def _compute_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def split_bias(bias, dt: torch.dtype) -> tuple:
    """`(inside, after)`: the bias a product in `dt` takes inside its call,
    and the one added to its result after it. flax's `nn.Conv` / `nn.Dense`
    round the product to the compute dtype and then add the bias in it, so
    under bf16 the bias goes after the rounded product; in fp32 (one
    rounding either way) it goes inside."""
    if bias is None:
        return None, None
    b = bias.to(dt)
    return (b, None) if torch.finfo(dt).bits >= 32 else (None, b)


class Conv2d(nn.Module):
    """2D conv on `[N, H, W, C]`; weight OIHW (a flax HWIO kernel transposed).

    The input is viewed as NCHW with channels-last strides, so cuDNN runs an
    NHWC convolution and no copy is made on the card.

    Band mode (`space`, a mesh with a `space` axis; set by
    `models/generator.py::shard_generator`): the input is this rank's band
    of rows, which the forward extends by `k // 2` rows of each neighbour
    (`parallel/mesh.py::halo_rows`, zeros past the image's edges) before
    it convolves with padding `(0, k // 2)`; the output is the band's rows
    of the whole convolution. The weights are the same."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True, dtype=None):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.dtype = dtype
        self.space = None
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        nn.init.normal_(self.weight, std=(cin * k * k) ** -0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def product(self, x: torch.Tensor) -> tuple:
        """`(y, after)`: the convolution in the compute dtype, with the bias
        that goes inside it, and the bias still to add after it (None in
        fp32; `split_bias`)."""
        dt = _compute_dtype(self.dtype, x)
        x, padding = x.to(dt), self.padding
        if self.space is not None:
            from cvpr23_lfdm_torch.parallel.mesh import halo_rows

            x, padding = halo_rows(x, padding, self.space), (0, padding)
        inside, after = split_bias(self.bias, dt)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), inside,
                     stride=self.stride, padding=padding).permute(0, 2, 3, 1)
        return y, after

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, after = self.product(x)
        return y if after is None else y + after


class Dense(nn.Linear):
    """`nn.Linear` (weight `[out, in]`, a flax Dense kernel transposed) with
    a compute dtype."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype=None):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        inside, after = split_bias(self.bias, dt)
        y = F.linear(x.to(dt), self.weight.to(dt), inside)
        return y if after is None else y + after


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (eps 1e-5, momentum 0.9), fp32 in and
    out, with flax's `nn.BatchNorm` statistics (`use_fast_variance`), not
    torch's. In train mode it normalises with the batch mean and the
    *biased* variance `max(0, E[x²] - E[x]²)` over every axis but the last,
    and folds that same variance into `running_var` (`torch.nn.BatchNorm2d`
    keeps the unbiased one there, N/(N-1) larger); the running statistics
    move only in train mode, in fp32, outside the autograd graph. In eval
    mode it normalises with the running statistics.

    `group` (set by :func:`sync_batchnorm`; the counterpart of flax's
    `axis_name`): a process group over which the train-mode statistics are
    taken, the reference's SyncBN. With more than one rank in it, the
    per-channel sums of x and x² and the row count are summed over the
    group (a sum whose backward is a sum, so the gradient reaches every
    rank's rows), and the same biased variance follows from them on every
    rank. `torch.nn.SyncBatchNorm` would keep the unbiased variance. With
    no group, or a group of one, the statistics are the local ones above."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.group = None
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eval()

    def _group_stats(self, x: torch.Tensor, axes: tuple):
        """Mean and biased variance over the rows of every rank of `group`."""
        from cvpr23_lfdm_torch.parallel.mesh import all_reduce_sum

        c = x.shape[-1]
        count = x.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([x.sum(dim=axes), x.square().sum(dim=axes), count]), self.group)
        mean = sums[:c] / sums[2 * c]
        return mean, ties.maximum(sums[c:2 * c] / sums[2 * c] - mean.square(), 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            if self.group is not None and dist.get_world_size(self.group) > 1:
                mean, var = self._group_stats(x, axes)
            else:
                mean = x.mean(dim=axes)
                var = ties.maximum(x.square().mean(dim=axes) - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


def sync_batchnorm(module: nn.Module, group):
    """Take the train-mode statistics of every `BatchNorm` in `module` over
    the ranks of `group` (None: each rank its own); returns `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


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

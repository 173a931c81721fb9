"""Inception-I3D (Kinetics-400), the published FVD feature extractor
(counterpart of `cvpr23_lfdm_tpu/eval/i3d.py`).

The standard FVD pipeline embeds videos with an I3D network pretrained on
Kinetics-400 and takes the Fréchet distance of the 400-d logits. The module
and parameter names are those of the de-facto torch weights
(piergiaj/pytorch-i3d `InceptionI3d`, the checkpoint `rgb_imagenet.pt`
family) and of the JAX package's tree, so a user who has the file loads it
with `i3d_extractor(convert_i3d_checkpoint(torch.load("rgb_imagenet.pt")))`.
No such file is in the repository.

Semantics held to the JAX package: TF-style dynamic SAME padding per
dimension (asymmetric: `F.pad` before the convolution), max pooling padded
with -inf (the JAX package's choice; pytorch_i3d pads with zeros), BatchNorm
eps 1e-3 on the running statistics, branch concat order b0, b1, b2, b3, and
the head: spatial mean, the sliding temporal mean of window 2, the logits
1x1x1 convolution with bias, then the time mean. The convolutions are cuDNN
calls (the JAX package runs them in XLA, outside any Pallas kernel). The
public layout is channel-last `[B, T, H, W, 3]`; inside, NCDHW.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.ops.resize import resize_bilinear
from cvpr23_lfdm_torch.utils.device import resolve_device

# (name, [b0, b1a, b1b, b2a, b2b, b3]): the GoogLeNet channel table
_MIXED: tuple[tuple[str, tuple[int, ...]], ...] = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _same_pads(shape, kernel, stride) -> list[tuple[int, int]]:
    """TF dynamic SAME padding (pytorch_i3d `compute_pad`), per dim:
    total = k - s if size % s == 0 else k - size % s (floored at 0)."""
    pads = []
    for size, k, s in zip(shape, kernel, stride):
        total = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """`x` NCDHW padded for a SAME window over (D, H, W)."""
    (dl, dr), (hl, hr), (wl, wr) = _same_pads(x.shape[2:], kernel, stride)
    return F.pad(x, (wl, wr, hl, hr, dl, dr), value=value)


class _BatchNorm(nn.Module):
    """Eval-mode BatchNorm (eps 1e-3, running statistics) over axis 1."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-3)


class Unit3D(nn.Module):
    """conv3d (SAME, no bias) -> BN (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, features: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, use_relu: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.use_relu = tuple(kernel), tuple(stride), use_relu
        self.conv3d = nn.Conv3d(cin, features, self.kernel, self.stride, bias=use_bias)
        self.bn = _BatchNorm(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


def _max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(_pad_same(x, kernel, stride, value=-float("inf")), kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, ch: Sequence[int]):  # ch: [b0, b1a, b1b, b2a, b2b, b3]
        super().__init__()
        self.b0 = Unit3D(cin, ch[0])
        self.b1a = Unit3D(cin, ch[1])
        self.b1b = Unit3D(ch[1], ch[2], (3, 3, 3))
        self.b2a = Unit3D(cin, ch[3])
        self.b2b = Unit3D(ch[3], ch[4], (3, 3, 3))
        self.b3b = Unit3D(cin, ch[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """Input `[B, T, H, W, 3]` (T >= 9 for the temporal strides at 224²),
    output `[B, num_classes]` logits (time-averaged). Built on the CPU with
    placeholder weights; load converted or seeded ones."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, ch in _MIXED:
            setattr(self, name, InceptionModule(cin, ch))
            cin = ch[0] + ch[2] + ch[4] + ch[5]
        self.logits = Unit3D(cin, num_classes, use_bn=False, use_relu=False, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for name, _ in _MIXED:
            x = getattr(self, name)(x)
            if name == "Mixed_3c":
                x = _max_pool_same(x, (3, 3, 3), (2, 2, 2))
            elif name == "Mixed_4f":
                x = _max_pool_same(x, (2, 2, 2), (2, 2, 2))
        # pytorch_i3d's head: AvgPool3d((2,7,7), stride 1) -> 1x1x1 logits conv
        # per temporal step -> mean over steps. The 7x7 window is the full
        # extent at 224² (a global spatial mean reproduces it and holds at
        # smaller test sizes); the temporal window-2 mean half-weights the
        # end steps whenever T' > 2, as published FVD numbers need
        x = x.mean(dim=(3, 4), keepdim=True)  # [B, C, T', 1, 1]
        if x.shape[2] > 1:
            x = (x[:, :, :-1] + x[:, :, 1:]) * 0.5
        return self.logits(x).mean(dim=(2, 3, 4))


def convert_i3d_checkpoint(sd: dict) -> dict[str, torch.Tensor]:
    """pytorch_i3d state dict (tensors or numpy arrays) -> an
    :class:`InceptionI3d` state dict. Keys: `<unit>.conv3d.weight` [O, I, T,
    H, W] (+ `.bias` on `logits`), `<unit>.bn.{weight, bias, running_mean,
    running_var}`; the names are the same on both sides, so this keeps those
    leaves (`num_batches_tracked` has no use) as fp32 CPU tensors."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[-2] == "conv3d" or (parts[-2] == "bn" and parts[-1] in _BN_LEAVES):
            out[key] = torch.as_tensor(val).detach().to("cpu", torch.float32).clone()
    return out


def random_i3d_vars(seed: int = 0, num_classes: int = 400) -> dict[str, torch.Tensor]:
    """Seeded I3D weights (tests, relative-FVD smoke runs): every conv kernel
    N(0, 2/fan_in) from `numpy.random.RandomState(seed)` in state-dict order
    (He: the activations keep their scale through the ReLU layers), the
    logits bias 0, BatchNorm at identity."""
    rng = np.random.RandomState(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in InceptionI3d(num_classes).state_dict().items()}
    out = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[1]
        if key.endswith("conv3d.weight"):
            fan_in = int(np.prod(shape[1:]))
            w = rng.standard_normal(tuple(shape)).astype(np.float32) * np.float32(np.sqrt(2.0 / fan_in))
            out[key] = torch.from_numpy(w)
        elif leaf in ("weight", "running_var"):
            out[key] = torch.ones(shape)
        else:
            out[key] = torch.zeros(shape)
    return out


def i3d_extractor(i3d_vars: dict, num_classes: int = 400, resize_to: int | None = 224,
                  device=None) -> Callable:
    """`[B, F, H, W, 3] in [0,1] -> [B, num_classes]` logits on `device` (the
    CUDA card unless it says otherwise), the published-FVD embedding:
    bilinear resize to 224² (`ops/resize.py::resize_bilinear`), values
    rescaled to [-1, 1]. `i3d_vars`: an :class:`InceptionI3d` state dict."""
    dev = resolve_device(device)
    model = InceptionI3d(num_classes)
    model.load_state_dict(i3d_vars)
    model = model.to(dev).eval().requires_grad_(False)

    @torch.no_grad()
    def extract(videos) -> torch.Tensor:
        x = torch.as_tensor(videos).to(dev, torch.float32)
        b, f, h, w, c = x.shape
        if resize_to is not None and (h, w) != (resize_to, resize_to):
            x = resize_bilinear(x.reshape(b * f, h, w, c), (resize_to, resize_to)).reshape(
                b, f, resize_to, resize_to, c)
        return model(x * 2.0 - 1.0)

    return extract

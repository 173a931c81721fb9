"""LPIPS (learned perceptual distance) on the published scale (counterpart of
`cvpr23_lfdm_tpu/eval/lpips.py`).

The official metric (Zhang et al., richzhang/PerceptualSimilarity,
net='vgg') is: scaling layer -> VGG16 slices relu{1_2,2_2,3_3,4_3,5_3} ->
channel-unit-normalize -> squared diff -> learned 1x1 "lin" weights ->
spatial mean -> sum over layers. Channel-last, with converters for both
weight files. Nothing is downloaded: a user who has the files (saved as

    torch.save(torchvision.models.vgg16(weights='DEFAULT').features.state_dict(), 'vgg16_features.pth')
    torch.save(lpips.LPIPS(net='vgg').state_dict(), 'lpips_vgg.pth')

on a machine that has them) builds
`make_lpips(convert_vgg16_features(torch.load(...)), convert_lpips_lin(torch.load(...)))`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d
from cvpr23_lfdm_torch.utils.device import resolve_device

# official LPIPS ScalingLayer constants (expects input in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision vgg16.features conv indices per LPIPS slice
_SLICES = [
    [(64, 0), (64, 2)],                          # -> relu1_2
    ["pool", (128, 5), (128, 7)],                # -> relu2_2
    ["pool", (256, 10), (256, 12), (256, 14)],   # -> relu3_3
    ["pool", (512, 17), (512, 19), (512, 21)],   # -> relu4_3
    ["pool", (512, 24), (512, 26), (512, 28)],   # -> relu5_3
]
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_CONVS = [item for plan in _SLICES for item in plan if item != "pool"]  # (out channels, index)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Vgg16Features(nn.Module):
    """The LPIPS backbone. Input `[B, H, W, 3]` already scaled to [-1, 1]
    (H, W multiples of 16); returns the five slice activations,
    channel-last. Its convolutions are `conv_{idx}`, after their torchvision
    index, as the JAX package names them."""

    def __init__(self):
        super().__init__()
        cin = 3
        for ch, idx in _CONVS:
            setattr(self, f"conv_{idx}", Conv2d(cin, ch, 3, padding=1))
            cin = ch
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = (x - self.shift) / self.scale
        outs = []
        for plan in _SLICES:
            for item in plan:
                if item == "pool":
                    x = _max_pool_2x2(x)
                else:
                    x = F.relu(getattr(self, f"conv_{item[1]}")(x))
            outs.append(x)
        return outs


def convert_vgg16_features(features_sd: dict) -> dict[str, torch.Tensor]:
    """torchvision `vgg16.features` state_dict (tensors or numpy arrays) ->
    a :class:`Vgg16Features` state dict (OIHW on both sides)."""
    return {f"conv_{idx}.{leaf}": torch.as_tensor(features_sd[f"{idx}.{leaf}"]).detach()
            .to("cpu", torch.float32).clone()
            for _, idx in _CONVS for leaf in ("weight", "bias")}


def convert_lpips_lin(lpips_sd: dict) -> list[torch.Tensor]:
    """Official LPIPS state dict -> the five learned per-channel weights
    (`lin{i}.model.1.weight` or `lins.{i}.model.1.weight`, `[1, C, 1, 1]` ->
    `[C]`)."""
    out = []
    for i, ch in enumerate(LPIPS_CHANNELS):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lpips_sd:
                w = torch.as_tensor(lpips_sd[key]).detach().to("cpu", torch.float32).reshape(-1)
                break
        else:
            raise KeyError(f"lin weights for slice {i} not found")
        if w.shape != (ch,):
            raise ValueError(f"lin weights of slice {i}: shape {tuple(w.shape)}, want ({ch},)")
        out.append(w.clone())
    return out


def make_lpips(vgg16_state: dict, lin_weights: list, device=None) -> Callable:
    """Published-scale LPIPS on `device` (the CUDA card unless it says
    otherwise): `fn(a, b) -> [B]` distances of `[B, H, W, 3]` images in
    [0, 1] (mapped to the official [-1, 1] domain inside)."""
    dev = resolve_device(device)
    model = Vgg16Features()
    model.load_state_dict(vgg16_state)
    model = model.to(dev).eval().requires_grad_(False)
    lins = [torch.as_tensor(w, dtype=torch.float32).to(dev) for w in lin_weights]

    @torch.no_grad()
    def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a = torch.as_tensor(a).to(dev, torch.float32)
        b = torch.as_tensor(b).to(dev, torch.float32)
        fa, fb = model(a * 2.0 - 1.0), model(b * 2.0 - 1.0)
        total = 0.0
        for w, xa, xb in zip(lins, fa, fb):
            na = xa / torch.sqrt(torch.sum(xa ** 2, -1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb ** 2, -1, keepdim=True) + 1e-10)
            d = torch.sum((na - nb) ** 2 * w, dim=-1)  # the lin 1x1 conv
            total = total + torch.mean(d, dim=(-2, -1))  # spatial average
        return total

    return distance


def random_lpips_for_testing(seed: int = 0, device=None) -> Callable:
    """Random-weight LPIPS on `device` (smoke runs and relative comparisons
    only): He normal kernels and zero biases from
    `numpy.random.RandomState(seed)`, then |N(0, 1)| lin weights."""
    rng = np.random.RandomState(seed)
    state, cin = {}, 3
    for ch, idx in _CONVS:
        w = rng.standard_normal((ch, cin, 3, 3)).astype(np.float32) * np.float32(np.sqrt(2.0 / (9 * cin)))
        state[f"conv_{idx}.weight"] = torch.from_numpy(w)
        state[f"conv_{idx}.bias"] = torch.zeros(ch)
        cin = ch
    lins = [torch.from_numpy(np.abs(rng.standard_normal(c)).astype(np.float32)) for c in LPIPS_CHANNELS]
    return make_lpips(state, lins, device=device)

"""VGG19 features for the perceptual pyramid loss (counterpart of
`cvpr23_lfdm_tpu/train/vgg.py`).

torchvision's VGG19 `features` cut at relu1_1 ... relu5_1, on an
ImageNet-normalised input, channel-last. Nothing is downloaded: the weights
come from `seed_vgg_weights` (a fixed random projection, a valid training
signal but not ImageNet features) or from a torchvision `vgg19.features`
state_dict the user supplies, through :func:`convert_torchvision_vgg19`.
The convolutions are named `conv_{idx}` after their torchvision index, as
the JAX package names them, so `from_jax_params` of its variables loads too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d

# conv plan per slice: (out_channels, torchvision feature index)
_SLICES = [
    [(64, 0)],                                             # -> relu1_1
    [(64, 2), "pool", (128, 5)],                           # -> relu2_1
    [(128, 7), "pool", (256, 10)],                         # -> relu3_1
    [(256, 12), (256, 14), (256, 16), "pool", (512, 19)],  # -> relu4_1
    [(512, 21), (512, 23), (512, 25), "pool", (512, 28)],  # -> relu5_1
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of `[B, H, W, C]` (even H and W, as the JAX
    package's reshape requires)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv_indices():
    return [item[1] for plan in _SLICES for item in plan if item != "pool"]


class Vgg19Features(nn.Module):
    """`[B, H, W, 3]` in [0, 1] -> `[relu1_1, ..., relu5_1]` (channel-last).
    H and W must be multiples of 16. Built on the CPU with fp32 weights;
    fill them with :func:`seed_vgg_weights` or a converted state_dict."""

    def __init__(self):
        super().__init__()
        cin = 3
        for plan in _SLICES:
            for item in plan:
                if item != "pool":
                    ch, idx = item
                    setattr(self, f"conv_{idx}", Conv2d(cin, ch, 3, padding=1))
                    cin = ch
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = (x - self.mean) / self.std
        outs = []
        for plan in _SLICES:
            for item in plan:
                if item == "pool":
                    x = _max_pool_2x2(x)
                else:
                    x = F.relu(getattr(self, f"conv_{item[1]}")(x))
            outs.append(x)
        return outs


def seed_vgg_weights(vgg: Vgg19Features, seed: int) -> None:
    """Fill every kernel from `numpy.random.RandomState(seed)`, N(0, 2/fan_in)
    (He: the activations keep their scale through the 16 ReLU layers), and
    every bias with 0, in the order of the feature index; the values do not
    depend on the torch version."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for idx in _conv_indices():
            conv = getattr(vgg, f"conv_{idx}")
            fan_in = int(np.prod(conv.weight.shape[1:]))
            vals = rng.standard_normal(tuple(conv.weight.shape)).astype(np.float32)
            conv.weight.copy_(torch.from_numpy(vals * np.float32(np.sqrt(2.0 / fan_in))))
            conv.bias.zero_()


def convert_torchvision_vgg19(features_sd: dict) -> dict[str, torch.Tensor]:
    """A torchvision `vgg19.features` state_dict (`{idx}.weight` OIHW,
    `{idx}.bias`; tensors or numpy arrays) -> a :class:`Vgg19Features`
    state_dict. The weights are OIHW on both sides: no transpose."""
    out = {}
    for idx in _conv_indices():
        for leaf in ("weight", "bias"):
            t = torch.as_tensor(features_sd[f"{idx}.{leaf}"])
            out[f"conv_{idx}.{leaf}"] = t.detach().to("cpu", torch.float32).clone()
    return out

"""Band-limited (anti-aliased) downsampling (counterpart of
`cvpr23_lfdm_tpu/ops/antialias.py`).

Gaussian blur as two 1-D depthwise convolutions with zero padding, then
stride slicing: `sigma = (1/scale - 1)/2`, `ksize = 2*round(4*sigma) + 1`
(13 taps at scale 0.25), subsampling by `int(1/scale)`. The taps are a
fixed constant, not a parameter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(scale: float) -> np.ndarray:
    """Normalized 1-D gaussian taps for a given downscale factor."""
    sigma = (1.0 / scale - 1.0) / 2.0
    ksize = 2 * round(sigma * 4) + 1
    mean = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((xs - mean) ** 2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


class AntiAliasDownsample:
    """Callable anti-aliased downsampler for `[B, H, W, C]` tensors."""

    def __init__(self, scale: float):
        self.scale = scale
        if scale != 1.0:
            self.kernel = gaussian_kernel_1d(scale)
            ksize = self.kernel.shape[0]
            self.ka = ksize // 2
            self.kb = self.ka - 1 if ksize % 2 == 0 else self.ka
            self.stride = int(round(1.0 / scale))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, C] -> [B, H*scale, W*scale, C]`."""
        if self.scale == 1.0:
            return x
        c = x.shape[-1]
        k = torch.from_numpy(self.kernel).to(device=x.device, dtype=x.dtype)
        y = x.permute(0, 3, 1, 2)
        # F.pad order: (W left, W right, H top, H bottom)
        y = F.conv2d(F.pad(y, (0, 0, self.ka, self.kb)),
                     k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        y = F.conv2d(F.pad(y, (self.ka, self.kb, 0, 0)),
                     k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
        return y[:, :, :: self.stride, :: self.stride].permute(0, 2, 3, 1)

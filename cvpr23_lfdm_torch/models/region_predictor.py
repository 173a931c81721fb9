"""Region predictor: soft-argmax region means + PCA covariance factor
(counterpart of `cvpr23_lfdm_tpu/models/region_predictor.py`).

Returns a dict of region parameters:
  shift   [B, K, 2]        soft-argmax means in [-1, 1] (x, y)
  covar   [B, K, 2, 2]     spatial covariance of each region heatmap
  affine  [B, K, 2, 2]     `U sqrt(S)` factor of covar
  heatmap [B, Hh, Wh, K]   softmaxed region maps (channel-last)

With `estimate_affine=True, pca_based=False` the regression branch is used
instead: a 4-channel conv head (zero weights, identity bias) predicts a
per-pixel jacobian that is heatmap-averaged into `affine`, and
`covar = affine @ affine^T`. The `regions`/`jacobian` convs pad by `pad` (3
for MUG; 0 for MHAD/NATOPS, where the heatmap shrinks by 6 pixels). The
module's `train`/`eval` mode is the JAX package's `train` argument (its
BatchNorms' batch or running statistics); softmax and moments in fp32, and
differentiable through the soft-argmax, the covariance and `sqrt_psd_2x2`.
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d, Hourglass
from cvpr23_lfdm_torch.ops.antialias import AntiAliasDownsample
from cvpr23_lfdm_torch.ops.eig2x2 import sqrt_psd_2x2
from cvpr23_lfdm_torch.ops.grid import make_coordinate_grid


class RegionPredictor(nn.Module):
    def __init__(self, num_regions: int = 10, num_channels: int = 3, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5, temperature: float = 0.1,
                 scale_factor: float = 0.25, pca_based: bool = True,
                 estimate_affine: bool = True, pad: int = 3, dtype=None):
        super().__init__()
        self.temperature = temperature
        self.pca_based = pca_based
        self.estimate_affine = estimate_affine
        self.down = AntiAliasDownsample(scale_factor)
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks, max_features, dtype)
        self.regions = Conv2d(self.predictor.out_filters, num_regions, 7, padding=pad)
        if estimate_affine and not pca_based:
            self.jacobian = Conv2d(self.predictor.out_filters, 4, 7, padding=pad)
            nn.init.zeros_(self.jacobian.weight)
            with torch.no_grad():
                self.jacobian.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]))
        self.eval()  # the JAX `train=False` default

    def forward(self, image: torch.Tensor) -> dict:
        """image: `[B, H, W, 3]` in [0, 1]."""
        feature_map = self.predictor(self.down(image))
        prediction = self.regions(feature_map)
        b, hh, wh, k = prediction.shape
        logits = prediction.reshape(b, hh * wh, k).float()
        region = torch.softmax(logits / self.temperature, dim=1)

        grid = make_coordinate_grid((hh, wh), device=image.device).reshape(1, hh * wh, 1, 2)
        shift = (region[..., None] * grid).sum(dim=1)  # [B, K, 2]
        out = {"shift": shift, "heatmap": region.reshape(b, hh, wh, k)}

        if self.estimate_affine and not self.pca_based:
            jac_map = self.jacobian(feature_map).reshape(b, hh * wh, 4).float()
            jac = torch.einsum("bzk,bzc->bkc", region, jac_map).reshape(b, k, 2, 2)
            out["affine"] = jac
            out["covar"] = jac @ jac.transpose(-1, -2)
        elif self.pca_based:
            diff = grid - shift[:, None]  # [B, HW, K, 2]
            covar = torch.einsum("bzk,bzki,bzkj->bkij", region, diff, diff)
            out["covar"] = covar
            out["affine"] = sqrt_psd_2x2(covar)
        return out

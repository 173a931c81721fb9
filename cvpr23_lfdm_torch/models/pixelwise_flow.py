"""Pixelwise dense flow predictor, the motion bottleneck (counterpart of
`cvpr23_lfdm_tpu/models/pixelwise_flow.py`).

Pipeline at 1/4 resolution (32x32 for 128² input):
  1. difference-of-gaussians heatmaps per region (+ a zero background map);
  2. K+1 sparse backward warp grids (per-region affine driving->source
     transforms + the background 3x3 grid);
  3. K+1 deformed copies of the source by ONE bilinear sample per video:
     the K+1 grids and, under frame folding, all F frames' grids are the
     frame axis of `ops.warp.warp_video`, so the source is never repeated;
  4. hourglass -> fp32 softmax mask -> convex combination = dense flow;
  5. optional occlusion head (sigmoid).

Outputs channel-last: flow `[B, h, w, 2]`, occlusion `[B, h, w, 1]`. Eval
mode only. The sample of step 3 is the `warp_video` kernel on the card
when no gradient is asked for (the frozen pseudo-ground-truth pass of DM
training), and the differentiable plain `ops.warp.grid_sample` otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from cvpr23_lfdm_torch.models.blocks import Conv2d, Hourglass
from cvpr23_lfdm_torch.ops import warp as warp_ops
from cvpr23_lfdm_torch.ops.antialias import AntiAliasDownsample
from cvpr23_lfdm_torch.ops.eig2x2 import inv_2x2
from cvpr23_lfdm_torch.ops.grid import (
    from_homogeneous, make_coordinate_grid, region2gaussian, to_homogeneous,
)


class PixelwiseFlowPredictor(nn.Module):
    def __init__(self, num_regions: int = 10, num_channels: int = 3, block_expansion: int = 64,
                 num_blocks: int = 5, max_features: int = 1024, scale_factor: float = 0.25,
                 region_var: float = 0.01, use_covar_heatmap: bool = True,
                 use_deformed_source: bool = True, estimate_occlusion_map: bool = True,
                 revert_axis_swap: bool = True, dtype=None):
        super().__init__()
        self.num_regions = num_regions
        self.region_var = region_var
        self.use_covar_heatmap = use_covar_heatmap
        self.use_deformed_source = use_deformed_source
        self.revert_axis_swap = revert_axis_swap
        self.down = AntiAliasDownsample(scale_factor)
        kp1 = num_regions + 1
        cin = kp1 * (1 + num_channels) if use_deformed_source else kp1
        self.hourglass = Hourglass(block_expansion, cin, num_blocks, max_features, dtype)
        self.mask = Conv2d(self.hourglass.out_filters, kp1, 7)
        self.occlusion = (Conv2d(self.hourglass.out_filters, 1, 7)
                          if estimate_occlusion_map else None)

    def _heatmaps(self, spatial_size, driving_params, source_params):
        """Difference-of-gaussians region maps `[B, h, w, K+1]` (background
        zeros first)."""
        covar_d = driving_params["covar"] if self.use_covar_heatmap else self.region_var
        covar_s = source_params["covar"] if self.use_covar_heatmap else self.region_var
        g_driving = region2gaussian(driving_params["shift"], covar_d, spatial_size)
        g_source = region2gaussian(source_params["shift"], covar_s, spatial_size)
        heatmap = (g_driving - g_source).permute(0, 2, 3, 1)
        return torch.cat([torch.zeros_like(heatmap[..., :1]), heatmap], dim=-1)

    def _sparse_motions(self, spatial_size, driving_params, source_params, bg_params):
        """K+1 backward warp grids `[B, K+1, h, w, 2]`; index 0 is the
        background grid."""
        h, w = spatial_size
        shift_d = driving_params["shift"]
        b = shift_d.shape[0]
        identity = make_coordinate_grid((h, w), dtype=shift_d.dtype, device=shift_d.device)
        coord = identity[None, None] - shift_d[:, :, None, None]  # [B, K, h, w, 2]
        if "affine" in driving_params:
            affine = source_params["affine"] @ inv_2x2(driving_params["affine"])
            if self.revert_axis_swap:
                affine = affine * torch.sign(affine[:, :, 0:1, 0:1])
            coord = torch.einsum("bkij,bkhwj->bkhwi", affine, coord)
        driving_to_source = coord + source_params["shift"][:, :, None, None]

        bg_grid = identity[None].expand(b, h, w, 2)
        if bg_params is not None:
            hom = torch.einsum("bij,bhwj->bhwi", bg_params, to_homogeneous(bg_grid))
            bg_grid = from_homogeneous(hom)
        return torch.cat([bg_grid[:, None], driving_to_source], dim=1)

    def _deformed_source(self, source, sparse_motions):
        """`source [B, h, w, C]` sampled at `sparse_motions [B*frames, K+1,
        h, w, 2]` -> `[B*frames, K+1, h, w, C]`, one sample per video."""
        b, h, w, c = source.shape
        bp, kp1 = sparse_motions.shape[:2]
        grids = sparse_motions.reshape(b, (bp // b) * kp1, h, w, 2)
        if torch.is_grad_enabled() and (source.requires_grad or grids.requires_grad):
            deformed = warp_ops.grid_sample(source, grids.reshape(b, -1, w, 2))
        else:
            deformed = warp_ops.warp_video(source.contiguous(), grids.float().contiguous())
        return deformed.reshape(bp, kp1, h, w, c)

    def forward(self, source_image, driving_params, source_params, bg_params=None,
                frames: int = 1) -> dict:
        """With `frames > 1`, `source_image` is `[B, H, W, C]` while the
        parameter dicts carry `B*frames` pair entries sharing each video's
        source: it is downsampled and sampled once per video."""
        source_image = self.down(source_image)
        _, h, w, c = source_image.shape
        kp1 = self.num_regions + 1

        heatmap = self._heatmaps((h, w), driving_params, source_params)
        sparse_motion = self._sparse_motions((h, w), driving_params, source_params, bg_params)
        b = sparse_motion.shape[0]  # pair batch from here on

        if self.use_deformed_source:
            deformed = self._deformed_source(source_image, sparse_motion)
            # per region [heatmap_k, deformed_k (C channels)], interleaved
            heat_k = heatmap.permute(0, 3, 1, 2)[..., None]  # [B, K+1, h, w, 1]
            per_region = torch.cat([heat_k, deformed.to(heat_k.dtype)], dim=-1)
            predictor_input = per_region.permute(0, 2, 3, 1, 4).reshape(b, h, w, kp1 * (1 + c))
        else:
            predictor_input = heatmap

        prediction = self.hourglass(predictor_input)
        mask = torch.softmax(self.mask(prediction).float(), dim=-1)  # [B, h, w, K+1]
        out = {"optical_flow": torch.einsum("bkhwc,bhwk->bhwc", sparse_motion, mask)}
        if self.occlusion is not None:
            out["occlusion_map"] = torch.sigmoid(self.occlusion(prediction))
        return out

"""Normalized coordinate grids (counterpart of `cvpr23_lfdm_tpu/ops/grid.py`).

Grids span `[-1, 1]^2` with align-corners spacing (`x_i = 2*i/(W-1) - 1`)
and the last axis in `(x, y)` order; they parameterize the backward warps
of :mod:`cvpr23_lfdm_torch.ops.warp`.
"""

from __future__ import annotations

import torch


def make_coordinate_grid(
    spatial_size: tuple[int, int], dtype=torch.float32, device=None
) -> torch.Tensor:
    """`[H, W, 2]` meshgrid over [-1,1]^2, last axis (x, y)."""
    h, w = spatial_size
    x = 2.0 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1.0
    xx = x[None, :].expand(h, w)
    yy = y[:, None].expand(h, w)
    return torch.stack([xx, yy], dim=-1)


def region2gaussian(center: torch.Tensor, covar, spatial_size: tuple[int, int]) -> torch.Tensor:
    """Rasterize per-region gaussians onto the [-1,1]^2 grid.

    Args:
      center: `[..., 2]` means in normalized (x, y) coordinates.
      covar: a scalar variance, or `[..., 2, 2]` covariance matrices.

    Returns `[..., H, W]` heatmaps.
    """
    from cvpr23_lfdm_torch.ops.eig2x2 import inv_2x2

    h, w = spatial_size
    grid = make_coordinate_grid(spatial_size, dtype=center.dtype, device=center.device)
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


def to_homogeneous(coords: torch.Tensor) -> torch.Tensor:
    """Append a 1-channel: `[..., 2] -> [..., 3]`."""
    return torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)


def from_homogeneous(coords: torch.Tensor) -> torch.Tensor:
    """Perspective divide: `[..., 3] -> [..., 2]`."""
    return coords[..., :2] / coords[..., 2:3]


def identity_flow_volume(
    b: int, f: int, h: int, w: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """`[B, F, H, W, 2]` identity backward-warp grid (residual-flow
    parameterization of the latent)."""
    grid = make_coordinate_grid((h, w), dtype=dtype, device=device)
    return grid[None, None].expand(b, f, h, w, 2)

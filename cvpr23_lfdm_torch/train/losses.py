"""LFAE reconstruction losses: the perceptual pyramid and the equivariance
constraint (counterpart of `cvpr23_lfdm_tpu/train/losses.py`).

The TPS transform's jacobian is the closed form of its 2 -> 2 map (the JAX
package takes `jax.jacfwd` of the same function): with `d = |x - c|_1` per
control point c, `J[i, j] = theta[i, j] + sum_c p_c * (2 d log(d + 1e-6) +
d² / (d + 1e-6)) * sign(x_j - c_j)`, the TPS term added to both output
coordinates. Its derivative of `|.|` is JAX's, +1 at 0 (`ops/ties.py`), and
it stays differentiable in the coordinates, which carry the region
predictor's gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from cvpr23_lfdm_torch.ops import ties
from cvpr23_lfdm_torch.ops.antialias import AntiAliasDownsample
from cvpr23_lfdm_torch.ops.eig2x2 import inv_2x2
from cvpr23_lfdm_torch.ops.grid import make_coordinate_grid
from cvpr23_lfdm_torch.ops.warp import grid_sample


def image_pyramid(x: torch.Tensor, scales) -> dict:
    """Anti-aliased multi-scale pyramid of `[B, H, W, C]`: `{scale: image}`."""
    return {s: AntiAliasDownsample(s)(x) for s in scales}


@dataclasses.dataclass(frozen=True)
class TPSTransform:
    """Random affine + thin-plate-spline warp of the equivariance constraint.

    `theta [B, 2, 3]`; `control_points [P², 2]` and `control_params [B, P²]`,
    or None for an affine warp alone."""

    theta: torch.Tensor
    control_points: torch.Tensor | None = None
    control_params: torch.Tensor | None = None

    @staticmethod
    def sample(generator: torch.Generator | None, bs: int, sigma_affine: float,
               sigma_tps: float | None = None, points_tps: int | None = None,
               device=None) -> "TPSTransform":
        """A random transform: `theta = I + sigma_affine * N(0, 1)` and TPS
        weights `sigma_tps * N(0, 1)` on a `points_tps²` grid, drawn from
        `generator` (on `device`) in that order."""
        device = generator.device if generator is not None else torch.device(device or "cpu")
        noise = torch.randn(bs, 2, 3, generator=generator, device=device)
        theta = torch.eye(2, 3, device=device)[None] + sigma_affine * noise
        cpar = None
        if sigma_tps is not None and points_tps is not None:
            cpar = sigma_tps * torch.randn(bs, points_tps ** 2, generator=generator, device=device)
        return TPSTransform.from_params(theta, cpar, points_tps)

    @staticmethod
    def from_params(theta: torch.Tensor, control_params: torch.Tensor | None = None,
                    points_tps: int | None = None) -> "TPSTransform":
        """The transform of given parameters (for example the ones another
        framework drew), its control points the `points_tps²` grid."""
        cp = None
        if control_params is not None:
            cp = make_coordinate_grid((points_tps, points_tps), device=theta.device).reshape(-1, 2)
        return TPSTransform(theta, cp, control_params)

    def _basis(self, coords: torch.Tensor):
        """Per control point: the L1 distance's offsets `[B, N, P, 2]` and
        the distance `[B, N, P]`."""
        diff = coords[:, :, None, :] - self.control_points[None, None]
        return diff, ties.abs_(diff).sum(-1)

    def warp_coordinates(self, coords: torch.Tensor) -> torch.Tensor:
        """coords `[B, N, 2]` -> warped `[B, N, 2]`."""
        out = torch.einsum("bij,bnj->bni", self.theta[:, :, :2], coords) + self.theta[:, None, :, 2]
        if self.control_points is not None:
            _, dist = self._basis(coords)
            basis = dist ** 2 * torch.log(dist + 1e-6)
            out = out + torch.einsum("bnp,bp->bn", basis, self.control_params)[..., None]
        return out

    def jacobian(self, coords: torch.Tensor) -> torch.Tensor:
        """d(warp)/d(coords) `[B, N, 2, 2]`, rows the output coordinate."""
        b, n, _ = coords.shape
        jac = self.theta[:, None, :, :2].expand(b, n, 2, 2)
        if self.control_points is not None:
            diff, dist = self._basis(coords)
            dbasis = 2 * dist * torch.log(dist + 1e-6) + dist ** 2 / (dist + 1e-6)
            sign = torch.where(diff >= 0, 1.0, -1.0)  # d|x|/dx, +1 at 0 as in JAX
            grad = torch.einsum("bnp,bp,bnpj->bnj", dbasis, self.control_params, sign)
            jac = jac + grad[:, :, None, :]
        return jac

    def transform_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """Warp `[B, H, W, C]` by the transform of its own coordinate grid,
        reflection padding."""
        b, h, w, _ = frame.shape
        grid = make_coordinate_grid((h, w), dtype=frame.dtype, device=frame.device)
        grid = grid.reshape(1, h * w, 2).expand(b, h * w, 2)
        warped = self.warp_coordinates(grid).reshape(b, h, w, 2)
        return grid_sample(frame, warped, padding_mode="reflection")


def perceptual_pyramid_loss(vgg, pred: torch.Tensor, target: torch.Tensor, scales, weights):
    """Multi-scale VGG L1: `sum_s sum_l w_l mean|vgg(pred_s)_l - vgg(target_s)_l|`.
    The target's features carry no gradient (JAX's `stop_gradient`): they
    are computed under `torch.no_grad`, which keeps them out of the graph."""
    pyr_pred = image_pyramid(pred, scales)
    with torch.no_grad():
        pyr_tgt = image_pyramid(target, scales)
    total = 0.0
    for s in scales:
        feats_pred = vgg(pyr_pred[s])
        with torch.no_grad():
            feats_tgt = vgg(pyr_tgt[s])
        for w, fp, ft in zip(weights, feats_pred, feats_tgt):
            total = total + w * ties.abs_(fp - ft).mean()
    return total


def equivariance_losses(driving_params: dict, transformed_params: dict, transform: TPSTransform,
                        revert_axis_swap: bool = True):
    """Shift and affine equivariance: `(shift_loss, affine_loss)`."""
    warped_shift = transform.warp_coordinates(transformed_params["shift"])
    shift_loss = ties.abs_(driving_params["shift"] - warped_shift).mean()

    jac = transform.jacobian(transformed_params["shift"])  # [B, K, 2, 2]
    affine_transformed = jac @ transformed_params["affine"]
    value = inv_2x2(driving_params["affine"]) @ affine_transformed
    if revert_axis_swap:
        value = value * torch.sign(value[:, :, 0:1, 0:1])
    eye = torch.eye(2, device=value.device, dtype=value.dtype)
    affine_loss = ties.abs_(eye - value).mean()
    return shift_loss, affine_loss

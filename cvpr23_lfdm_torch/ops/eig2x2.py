"""Closed-form 2x2 symmetric-PSD matrix math (counterpart of
`cvpr23_lfdm_tpu/ops/eig2x2.py`).

The region predictor factorizes a per-region 2x2 covariance `C = U S U^T`
(S descending) and consumes `U sqrt(S)`. The closed form keeps it on the
device and fixes the column signs by a deterministic convention (each
eigenvector's largest-magnitude component is non-negative), which
`torch.linalg.eigh` would not reproduce.

Where the JAX package takes `jnp.maximum`, this file takes `ops.ties.maximum`,
which gives each side half the gradient at a tie as JAX does
(`torch.clamp_min` gives all of it to one side), so gradients agree at
degenerate covariances too.

One departure: for a thin matrix (smaller eigenvalue under `_THIN` of the
larger) the smaller eigenvalue is `det / s1`, not the JAX package's
`tr / 2 - rad`. The two are the same number, but the difference cancels in
fp32: for a thin region (variances 6.1e-9 and 0.35, recorded on the card in
`tests/golden/lfae_nan_sqrt_psd.npz`) it rounds to 0, and `sqrt(S)` and
`inv_2x2` of the factor then give an infinite gradient or a singular matrix,
which made LFAE training go NaN. The determinant is taken in float64 (the
products of fp32 entries are exact there), so that eigenvalue is exact to
fp32 rounding. Every other matrix takes the JAX package's expression, and a
truly singular one (determinant 0) gets the same 0 from both.
"""

from __future__ import annotations

import torch

from cvpr23_lfdm_torch.ops.ties import maximum

_EPS = 1e-12
# below this ratio of the eigenvalues, fp32 `tr / 2 - rad` keeps fewer than
# ~4 significant digits of the smaller one
_THIN = 1e-3


def _lead_sign(v: torch.Tensor) -> torch.Tensor:
    """+-1 `[..., 1]` making the largest-|.| component of `v [..., 2]` >= 0."""
    lead = torch.where(v[..., 0].abs() >= v[..., 1].abs(), v[..., 0], v[..., 1])
    return torch.where(lead < 0, -1.0, 1.0).to(v.dtype)[..., None]


def eigh_2x2(covar: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric `[..., 2, 2]` matrices.

    Returns `(u, s)`: `u [..., 2, 2]` orthonormal eigenvectors as columns,
    `s [..., 2]` eigenvalues sorted descending.
    """
    a = covar[..., 0, 0]
    b = 0.5 * (covar[..., 0, 1] + covar[..., 1, 0])
    c = covar[..., 1, 1]

    half_tr = 0.5 * (a + c)
    rad = torch.sqrt(maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    s1 = half_tr + rad
    s2 = half_tr - rad
    # a thin matrix's smaller eigenvalue without cancellation: det / s1 (see
    # the docstring)
    thin = s2 < _THIN * s1
    det = a.double() * c.double() - b.double() * b.double()
    s2 = torch.where(thin, (det / torch.where(thin, s1, 1.0).double()).to(s1.dtype), s2)

    # eigenvector for s1: (b, s1 - a) or (s1 - c, b), the larger-norm one
    v1a = torch.stack([b, s1 - a], dim=-1)
    v1b = torch.stack([s1 - c, b], dim=-1)
    n1a = (v1a * v1a).sum(dim=-1, keepdim=True)
    n1b = (v1b * v1b).sum(dim=-1, keepdim=True)
    v1 = torch.where(n1a >= n1b, v1a, v1b)
    # isotropic case: fall back to e1
    e1 = torch.zeros_like(v1)
    e1[..., 0] = 1.0
    norm1 = torch.sqrt((v1 * v1).sum(dim=-1, keepdim=True))
    v1 = torch.where(norm1 > _EPS, v1 / maximum(norm1, _EPS), e1)
    v1 = v1 * _lead_sign(v1)

    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    v2 = v2 * _lead_sign(v2)

    u = torch.stack([v1, v2], dim=-1)  # columns are eigenvectors
    s = torch.stack([s1, s2], dim=-1)
    return u, s


def sqrt_psd_2x2(covar: torch.Tensor) -> torch.Tensor:
    """`U sqrt(S)` factor of a symmetric PSD 2x2: `out @ out.T == covar`."""
    u, s = eigh_2x2(covar)
    return u * torch.sqrt(maximum(s, 0.0))[..., None, :]


def inv_2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of `[..., 2, 2]` matrices."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def inv_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of `[..., 3, 3]` matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    adj = torch.stack(
        [
            torch.stack([ca, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([cb, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([cc, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]

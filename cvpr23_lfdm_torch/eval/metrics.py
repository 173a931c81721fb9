"""Quality metrics: PSNR / SSIM / LPIPS-style / FVD (Fréchet video distance)
(counterpart of `cvpr23_lfdm_tpu/eval/metrics.py`).

* PSNR / SSIM: exact, on tensors of any device (video = mean over frames).
* LPIPS-style perceptual distance over `Vgg19Features` activations with
  pluggable per-layer linear weights (the published LPIPS is `eval/lpips.py`).
* FVD: the Fréchet distance between the feature distributions of a pluggable
  `[B, F, H, W, 3] -> [B, D]` extractor (the published metric: the I3D
  logits of `eval/i3d.py::i3d_extractor`), with the paper's condition-grouped
  cFVD / sFVD. The Gaussian statistics and the matrix square root stay on
  the host in float64 (`scipy.linalg.sqrtm`), as in the JAX package.

Inputs are channel-last, `[..., H, W, C]` in [0, max_val].
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------- PSNR


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR over leading dims; inputs `[..., H, W, C]` in [0, max_val]."""
    mse = ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return torch.mean(10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12)))


# ------------------------------------------------------------------- SSIM


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Standard Wang et al. SSIM with an 11x11 Gaussian window (sigma 1.5),
    VALID, channels and leading dims averaged. Inputs `[..., H, W, C]`. The
    window is separable: a depthwise 1-D convolution along H, then along W,
    in the JAX package's order."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    h, w, c = a.shape[-3:]
    kern = _gaussian_kernel(device=a.device)
    along_h = kern.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    along_w = kern.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    af = a.reshape(-1, h, w, c).float().permute(0, 3, 1, 2)
    bf = b.reshape(-1, h, w, c).float().permute(0, 3, 1, 2)

    def blur(x):
        return F.conv2d(F.conv2d(x, along_h, groups=c), along_w, groups=c)

    mu_a, mu_b = blur(af), blur(bf)
    var_a = blur(af * af) - mu_a ** 2
    var_b = blur(bf * bf) - mu_b ** 2
    cov = blur(af * bf) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


# ------------------------------------------------------------- LPIPS-style


def lpips_distance(vgg_apply: Callable, a: torch.Tensor, b: torch.Tensor,
                   lin_weights: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Perceptual distance: unit-normalize each VGG activation over channels,
    per-layer (weighted) squared difference, spatial mean, sum over layers:
    the LPIPS recipe (Zhang et al.). `a`/`b`: `[B, H, W, 3]` in [0, 1]."""
    feats_a = vgg_apply(a)
    feats_b = vgg_apply(b)
    total = 0.0
    for li, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        na = fa / torch.sqrt(torch.sum(fa ** 2, dim=-1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(torch.sum(fb ** 2, dim=-1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2
        if lin_weights is not None:
            d = d * torch.as_tensor(lin_weights[li], device=d.device)[None, None, None, :]
            total = total + torch.mean(torch.sum(d, dim=-1))
        else:
            total = total + torch.mean(d)  # plain mean per layer
    return total


# -------------------------------------------------------------------- FVD


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """Fréchet distance between two Gaussians (the FID/FVD formula)."""
    import scipy.linalg

    diff = mu1 - mu2
    # scipy <1.17 returns (X, errest) with disp=False; 1.17 deprecates
    # `disp` and returns X alone on some inputs: accept both
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def feature_statistics(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(0)
    # n=1 has no sample covariance; use zeros (a point mass) instead of
    # np.cov's NaNs so degenerate eval groups yield a finite distance
    if feats.shape[0] < 2:
        return mu, np.zeros((feats.shape[1], feats.shape[1]))
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def extract_features(extractor: Callable, videos, batch_size: int = 8) -> np.ndarray:
    """Run a `[B, F, H, W, 3] -> [B, D]` extractor over a video set (numpy
    array or tensor) in fixed-size batches: the ragged tail pads by
    repetition and crops, so every call sees the same batch. Returns the
    features as a float32 numpy array."""
    n = len(videos)
    outs = []
    for i in range(0, n, batch_size):
        chunk = videos[i: i + batch_size]
        chunk = chunk if torch.is_tensor(chunk) else torch.from_numpy(np.asarray(chunk))
        take = len(chunk)
        if take < batch_size:  # pad to the full batch
            chunk = torch.cat([chunk] * -(-batch_size // take))[:batch_size]
        with torch.no_grad():
            feats = extractor(chunk)
        outs.append(feats.float().cpu().numpy()[:take])
    return np.concatenate(outs)


@dataclasses.dataclass
class FVD:
    """Fréchet video distance over a pluggable extractor.

    `extractor`: `[B, F, H, W, 3] in [0,1] -> [B, D]` features. The standard
    metric uses I3D (Kinetics-400) logits (`i3d_extractor(...)` with converted
    weights); for relative comparisons any fixed extractor is consistent."""

    extractor: Callable

    def __call__(self, real_videos, fake_videos, batch_size: int = 8) -> float:
        mu_r, s_r = feature_statistics(extract_features(self.extractor, real_videos, batch_size))
        mu_f, s_f = feature_statistics(extract_features(self.extractor, fake_videos, batch_size))
        return frechet_distance(mu_r, s_r, mu_f, s_f)

    def grouped(self, real_videos, fake_videos, real_groups, fake_groups,
                batch_size: int = 8) -> tuple[float, dict[str, float]]:
        """Condition-grouped FVD, the paper's cFVD/sFVD protocol
        (arXiv:2303.13744 Tables 1-3): partition both sets by a condition
        label (class text -> cFVD, subject id -> sFVD), compute the Fréchet
        distance within each condition, and average over conditions.

        Features are extracted once per set and sliced per group. Groups
        present in only one set are skipped (reported as NaN per group).
        Returns `(mean over valid groups, {group: value})`."""
        fr = extract_features(self.extractor, real_videos, batch_size)
        ff = extract_features(self.extractor, fake_videos, batch_size)
        real_groups = [str(g) for g in real_groups]
        fake_groups = [str(g) for g in fake_groups]
        if len(real_groups) != len(fr) or len(fake_groups) != len(ff):
            raise ValueError("one group label per video required")
        per: dict[str, float] = {}
        for g in sorted(set(real_groups) | set(fake_groups)):
            ri = [i for i, x in enumerate(real_groups) if x == g]
            fi = [i for i, x in enumerate(fake_groups) if x == g]
            if not ri or not fi:
                per[g] = float("nan")
                continue
            mu_r, s_r = feature_statistics(fr[ri])
            mu_f, s_f = feature_statistics(ff[fi])
            per[g] = frechet_distance(mu_r, s_r, mu_f, s_f)
        valid = [v for v in per.values() if np.isfinite(v)]
        return float(np.mean(valid)) if valid else float("nan"), per


def vgg_video_extractor(vgg_apply: torch.nn.Module, layer: int = 3) -> Callable:
    """A video feature extractor without I3D weights: spatial and temporal
    means of one activation of every frame, from `vgg_apply` (a
    `train/vgg.py::Vgg19Features`, on the device it runs on; the videos are
    moved there). Fixed and deterministic: valid for relative FVD
    comparisons, not the published I3D-FVD scale."""

    def extract(videos: torch.Tensor) -> torch.Tensor:
        videos = torch.as_tensor(videos).to(next(vgg_apply.parameters()).device, torch.float32)
        b, f = videos.shape[:2]
        frames = videos.reshape((b * f,) + tuple(videos.shape[2:]))
        pooled = vgg_apply(frames)[layer].mean(dim=(1, 2))
        return pooled.reshape(b, f, -1).mean(dim=1)

    return extract

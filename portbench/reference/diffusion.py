"""The diffusion of the reference: the cosine schedule, the training loss
(eps objective, l2) and the DDIM sampler with dynamic thresholding, as the
port's `diffusion/{schedule,gaussian_diffusion}.py` compute them. Every
random draw is given (the harness makes them from the seed). The
per-sample quantile of the threshold is `torch.quantile` (linear
interpolation), the same order statistic the port takes with `kthvalue`.
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    """The cosine beta schedule's per-step constants, fp32 `[T]` tensors
    computed in float64."""

    def __init__(self, timesteps: int, device):
        s = 0.008
        x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
        ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        ac = ac / ac[0]
        betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.9999)
        alphas_cumprod = np.cumprod(1.0 - betas)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.timesteps = timesteps
        self.alphas_cumprod_prev = t(np.concatenate([[1.0], alphas_cumprod[:-1]]))
        self.sqrt_alphas_cumprod = t(np.sqrt(alphas_cumprod))
        self.sqrt_one_minus_alphas_cumprod = t(np.sqrt(1.0 - alphas_cumprod))
        self.sqrt_recip_alphas_cumprod = t(np.sqrt(1.0 / alphas_cumprod))
        self.sqrt_recipm1_alphas_cumprod = t(np.sqrt(1.0 / alphas_cumprod - 1.0))


def _at(a, t, ndim):
    return a[t].reshape(-1, *((1,) * (ndim - 1)))


def dynamic_threshold(x0, percentile):
    b = x0.shape[0]
    s = torch.quantile(x0.abs().reshape(b, -1).float(), percentile, dim=-1)
    s = s.clamp_min(1.0).reshape(b, *((1,) * (x0.ndim - 1)))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def p_losses(denoise, sched: Schedule, x_start, fea, cond, t, noise, null_mask):
    """The l2 eps loss of one batch: `mean((noise - denoise(q_sample))²)`."""
    x_noisy = (_at(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
               + _at(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)
    pred = denoise(x_noisy, t, cond, null_mask, fea[:, None])
    return ((noise - pred) ** 2).mean()


def ddim_sample(denoise, sched: Schedule, sampling_steps: int, eta: float, percentile: float,
                fea, cond, init_img, noise_seq):
    """DDIM over `sampling_steps` (cond_scale 1: the condition without a
    null branch), `alphas_cumprod_prev` at both times, no noise on the step
    to t = 0, x0 clipped by the dynamic threshold."""
    times = np.linspace(0.0, sched.timesteps, sampling_steps + 2)[:-1]
    times = list(reversed(times.astype(np.int64).tolist()))
    t_cur, t_next = times[:-1], times[1:]
    acp = sched.alphas_cumprod_prev
    alpha, alpha_next = acp[torch.tensor(t_cur, device=acp.device)], acp[torch.tensor(t_next, device=acp.device)]
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
    coef = torch.sqrt(torch.clamp_min((1 - alpha_next) - sigma ** 2, 0.0))
    img = init_img.float()
    b = img.shape[0]
    no_null = torch.zeros(b, dtype=torch.bool, device=img.device)
    for i, (tc, tn) in enumerate(zip(t_cur, t_next)):
        t = torch.full((b,), tc, dtype=torch.long, device=img.device)
        eps = denoise(img, t, cond, no_null, fea[:, None])
        x0 = (_at(sched.sqrt_recip_alphas_cumprod, t, img.ndim) * img
              - _at(sched.sqrt_recipm1_alphas_cumprod, t, img.ndim) * eps)
        x0 = dynamic_threshold(x0, percentile)
        noise = torch.zeros_like(img) if tn == 0 else noise_seq[i].float()
        img = x0 * torch.sqrt(alpha_next[i]) + coef[i] * eps + sigma[i] * noise
    return img

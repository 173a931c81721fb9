"""Gaussian diffusion: the training loss and the DDPM/DDIM samplers
(counterpart of `cvpr23_lfdm_tpu/diffusion/gaussian_diffusion.py`).

The denoiser is an injected function `denoise(x, t, cond, null_cond_mask,
fea) -> prediction` (eps / x0 / v per `objective`). Classifier-free
guidance batches {cond, null} into one denoiser call; dynamic thresholding
clips x0 to the per-sample 0.9-quantile of |x0| (min 1). The JAX scans are
Python loops here. `init_img`/`noise_seq` inject the gaussians, otherwise
they come from the given `torch.Generator`; `p_losses` likewise takes its
timesteps, noise and null-condition dropout from the generator unless they
are injected.

Volumes are channel-last `[B, F, h, w, C]` (C = 3: 2 flow + 1 conf).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cvpr23_lfdm_torch.diffusion.schedule import DiffusionSchedule
from cvpr23_lfdm_torch.ops.quantile import quantile_nonneg
from cvpr23_lfdm_torch.utils.tracing import span


@functools.cache
def _device_index(ts: tuple, device: torch.device) -> torch.Tensor:
    """`ts` as an index tensor on `device`, uploaded once per (ts, device):
    a sampler call enqueues its work without waiting on a copy."""
    return torch.tensor(ts, device=device)


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def dynamic_threshold(x0: torch.Tensor, percentile: float = 0.9) -> torch.Tensor:
    """Clip to the per-sample |x0| quantile (min 1) and scale into [-1, 1]."""
    b = x0.shape[0]
    s = quantile_nonneg(x0.abs().reshape(b, -1), percentile)
    s = torch.clamp_min(s, 1.0).reshape(b, *((1,) * (x0.ndim - 1)))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule
    timesteps: int = 1000
    sampling_timesteps: int = 1000
    ddim_sampling_eta: float = 1.0
    loss_type: str = "l2"
    use_dynamic_thres: bool = True
    dynamic_thres_percentile: float = 0.9
    null_cond_prob: float = 0.1
    objective: str = "eps"

    @staticmethod
    def create(cfg, device=None) -> "GaussianDiffusion":
        """Build from a DiffusionConfig."""
        return GaussianDiffusion(
            schedule=DiffusionSchedule.create(cfg.timesteps, device=device),
            timesteps=cfg.timesteps,
            sampling_timesteps=cfg.sampling_timesteps,
            ddim_sampling_eta=cfg.ddim_sampling_eta,
            loss_type=cfg.loss_type,
            null_cond_prob=cfg.null_cond_prob,
            use_dynamic_thres=cfg.use_dynamic_thres,
            dynamic_thres_percentile=cfg.dynamic_thres_percentile,
            objective=cfg.objective,
        )

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps

    # ---------------------------------------------------------------- x0 / eps

    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
        )

    def predict_v(self, x_start, t, noise):
        """v := sqrt(ab)*eps - sqrt(1-ab)*x0."""
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start
        )

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0
        ) / _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)

    def predict_start_from_v(self, x_t, t, v):
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
        )

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        mean = (
            _extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t
        )
        return mean, _extract(s.posterior_log_variance_clipped, t, x_t.ndim)

    def _maybe_threshold(self, x0):
        with span("threshold"):
            if self.use_dynamic_thres:
                return dynamic_threshold(x0, self.dynamic_thres_percentile)
            return x0.clamp(-1.0, 1.0)

    def _pred_to_x0_eps(self, x_t, t, pred):
        """`(x0, eps)` with x0 thresholded. For "eps" the raw prediction is
        eps; for "x0"/"v" eps is derived from the thresholded x0."""
        if self.objective == "eps":
            return self._maybe_threshold(self.predict_start_from_noise(x_t, t, pred)), pred
        if self.objective == "x0":
            x0 = self._maybe_threshold(pred)
        elif self.objective == "v":
            x0 = self._maybe_threshold(self.predict_start_from_v(x_t, t, pred))
        else:
            raise NotImplementedError(self.objective)
        return x0, self.predict_noise_from_start(x_t, t, x0)

    # ---------------------------------------------------------------- loss

    def training_draws(self, shape, with_cond: bool, generator, device, t=None, noise=None,
                       null_mask=None):
        """The random draws of `p_losses` for a batch of `shape` (the latent
        volume's), in its order: timesteps `[B]` uniform in [0, T), the
        gaussian (fp32) and, `with_cond`, the null-condition dropout `[B]`
        with probability `null_cond_prob`; what is given is kept, and
        nothing is drawn for it. A data-parallel step draws the global
        batch's on every rank and keeps its own rows."""
        b = shape[0]
        if t is None:
            t = torch.randint(0, self.timesteps, (b,), generator=generator, device=device)
        if noise is None:
            noise = _normal(shape, generator, device)
        if with_cond and null_mask is None:
            null_mask = torch.rand(b, generator=generator, device=device) < self.null_cond_prob
        return t, noise, null_mask

    def p_losses(self, denoise, x_start, fea, cond=None, none_cond_mask=None,
                 t=None, noise=None, null_mask=None, generator=None):
        """Training objective.

        Args:
          denoise: the denoiser (gradients flow through it).
          x_start: `[B, F, h, w, 3]` latent flow volume in [-1, 1].
          fea: `[B, h, w, Cf]` reference image feature (broadcast over F).
          cond: `[B, cond_dim]` text embeddings.
          none_cond_mask: `[B]` bool, True for "None" texts (forced null).
          t, noise, null_mask: optional explicit timesteps `[B]`, gaussian
            `x_start.shape` and null-condition dropout `[B]` bool; what is
            missing is drawn from `generator` (t uniform in [0, T), dropout
            with probability `null_cond_prob`).

        Returns `(scalar loss, {"pred_x0": thresholded x0 estimate (detached),
        "t": t})`.
        """
        drawn_noise = noise is None
        t, noise, null_mask = self.training_draws(x_start.shape, cond is not None, generator,
                                                  x_start.device, t, noise, null_mask)
        if drawn_noise:
            noise = noise.to(x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)

        if cond is None:
            null_mask = None
        elif none_cond_mask is not None:
            null_mask = null_mask | none_cond_mask

        pred = denoise(x_noisy, t, cond, null_mask, fea[:, None])

        if self.objective == "eps":
            target = noise
        elif self.objective == "x0":
            target = x_start
        elif self.objective == "v":
            target = self.predict_v(x_start, t, noise)
        else:
            raise NotImplementedError(self.objective)

        if self.loss_type == "l1":
            loss = (target - pred).abs().mean()
        elif self.loss_type == "l2":
            loss = ((target - pred) ** 2).mean()
        else:
            raise NotImplementedError(self.loss_type)

        with torch.no_grad():  # monitoring only: no graph through the threshold
            pred_x0, _ = self._pred_to_x0_eps(x_noisy, t, pred.detach())
        return loss, {"pred_x0": pred_x0, "t": t}

    # ---------------------------------------------------------------- CFG

    def _guided_pred(self, denoise, x_in, t, cond, cond_scale: float, fea):
        """One batched denoiser call for classifier-free guidance; `fea` is
        `[B, 1, h, w, Cf]`."""
        with span("denoise"):
            b = x_in.shape[0]
            false_mask = torch.zeros(b, dtype=torch.bool, device=x_in.device)
            true_mask = torch.ones(b, dtype=torch.bool, device=x_in.device)
            if cond_scale == 0.0 or cond is None:
                return denoise(x_in, t, cond, true_mask, fea)
            if cond_scale == 1.0:
                return denoise(x_in, t, cond, false_mask, fea)
            pred2 = denoise(
                torch.cat([x_in, x_in]), torch.cat([t, t]), torch.cat([cond, cond]),
                torch.cat([false_mask, true_mask]), torch.cat([fea, fea]),
            )
            pred_cond, pred_null = pred2[:b], pred2[b:]
            return pred_null + (pred_cond - pred_null) * cond_scale

    # ---------------------------------------------------------------- samplers

    def p_sample_loop(self, denoise, shape, fea, cond=None, cond_scale: float = 1.0,
                      init_img=None, noise_seq=None, generator=None):
        """Ancestral sampler over all T steps."""
        device = fea.device
        img = _normal(shape, generator, device) if init_img is None else init_img
        fea_1 = fea[:, None]
        for i, t_scalar in enumerate(range(self.timesteps - 1, -1, -1)):
            with span("sampler_step"):
                noise = _normal(shape, generator, device) if noise_seq is None else noise_seq[i]
                t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
                pred = self._guided_pred(denoise, img, t, cond, cond_scale, fea_1)
                x0, _ = self._pred_to_x0_eps(img, t, pred)
                mean, log_var = self.q_posterior(x0, img, t)
                nonzero = float(t_scalar > 0)
                img = mean + nonzero * torch.exp(0.5 * log_var) * noise
        return img

    def ddim_times(self) -> tuple[list[int], list[int]]:
        """(time, time_next) pairs: linspace truncated to int, reversed."""
        times = np.linspace(0.0, self.timesteps, self.sampling_timesteps + 2)[:-1]
        times = list(reversed(times.astype(np.int64).tolist()))
        return times[:-1], times[1:]

    def ddim_sample(self, denoise, shape, fea, cond=None, cond_scale: float = 1.0,
                    init_img=None, noise_seq=None, generator=None):
        """DDIM sampler. The reference indexes `alphas_cumprod_prev` at both
        times; the noise is zeroed on the step to t_next == 0."""
        device = fea.device
        eta = self.ddim_sampling_eta
        s = self.schedule
        img = _normal(shape, generator, device) if init_img is None else init_img
        fea_1 = fea[:, None]
        t_cur, t_next = self.ddim_times()
        alpha = s.alphas_cumprod_prev[_device_index(tuple(t_cur), s.alphas_cumprod_prev.device)]
        alpha_next = s.alphas_cumprod_prev[_device_index(tuple(t_next), s.alphas_cumprod_prev.device)]
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        coef = torch.sqrt(torch.clamp_min((1 - alpha_next) - sigma ** 2, 0.0))
        for i, (tc, tn) in enumerate(zip(t_cur, t_next)):
            with span("sampler_step"):
                noise = _normal(shape, generator, device) if noise_seq is None else noise_seq[i]
                t = torch.full((shape[0],), tc, dtype=torch.long, device=device)
                pred = self._guided_pred(denoise, img, t, cond, cond_scale, fea_1)
                x0, eps = self._pred_to_x0_eps(img, t, pred)
                if tn == 0:
                    noise = torch.zeros_like(noise)
                img = x0 * torch.sqrt(alpha_next[i]) + coef[i] * eps + sigma[i] * noise
        return img

    def interpolate(self, denoise, x1, x2, fea, cond=None, cond_scale: float = 1.0,
                    t: int | None = None, lam: float = 0.5, noise1=None, noise2=None,
                    noise_seq=None, generator=None):
        """Latent interpolation (video_flow_diffusion.py:832-846): noise both
        volumes to step `t` (default T - 1) with independent gaussians, lerp
        by `lam`, then denoise ancestrally over steps t-1 .. 0. The
        reference's version is dead code (it calls `p_sample` without
        `fea`); this is the JAX package's repaired semantics, conditioning
        threaded through as in the other samplers. `noise1`, `noise2` (each
        `x1.shape`) and `noise_seq` (`[t, *x1.shape]`) inject the gaussians,
        otherwise they come from `generator`, in that order."""
        if x1.shape != x2.shape:
            raise ValueError(f"interpolate: shapes {tuple(x1.shape)} and {tuple(x2.shape)} differ")
        b = x1.shape[0]
        device = x1.device
        t = self.timesteps - 1 if t is None else t
        tb = torch.full((b,), t, dtype=torch.long, device=device)
        if noise1 is None:
            noise1 = _normal(x1.shape, generator, device).to(x1.dtype)
        if noise2 is None:
            noise2 = _normal(x1.shape, generator, device).to(x1.dtype)
        img = (1 - lam) * self.q_sample(x1, tb, noise1) + lam * self.q_sample(x2, tb, noise2)
        fea_1 = fea[:, None]
        for i, t_scalar in enumerate(range(t - 1, -1, -1)):
            with span("sampler_step"):
                noise = _normal(x1.shape, generator, device).to(x1.dtype) if noise_seq is None else noise_seq[i]
                tt = torch.full((b,), t_scalar, dtype=torch.long, device=device)
                pred = self._guided_pred(denoise, img, tt, cond, cond_scale, fea_1)
                x0, _ = self._pred_to_x0_eps(img, tt, pred)
                mean, log_var = self.q_posterior(x0, img, tt)
                img = mean + float(t_scalar > 0) * torch.exp(0.5 * log_var) * noise
        return img

    def sample(self, denoise, fea, cond=None, cond_scale: float = 1.0,
               batch_size: int = 1, num_frames: int = 40, channels: int = 3,
               image_size: int = 32, init_img=None, noise_seq=None, generator=None):
        """DDPM or DDIM, by `sampling_timesteps`."""
        if cond is not None:
            batch_size = cond.shape[0]
        shape = (batch_size, num_frames, image_size, image_size, channels)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(denoise, shape, fea, cond, cond_scale, init_img=init_img,
                  noise_seq=noise_seq, generator=generator)

"""DM trainer: one loop for MUG/MHAD/NATOPS on one device (counterpart of
`cvpr23_lfdm_tpu/train/dm_trainer.py`; mesh, sharding and prefetch belong
to the multi-device slice).

The trainer owns the model (`FlowDiffusion` in its training form: frozen
LFAE, trainable UNet with fp32 parameters and gradients) and the
optimizer; `DMTrainState` is the step counter that indexes the learning
rate schedule and the per-step random stream. A batch is a dict of numpy
arrays or tensors: `ref_img [B, H, W, 3]`, `real_vid [B, F, H, W, 3]`,
`cond [B, cond_dim]` and optionally `none_cond_mask [B]`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from cvpr23_lfdm_torch.config import ExperimentConfig
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion, build_unet
from cvpr23_lfdm_torch.train.optim import MultistepAdam


@dataclasses.dataclass
class DMTrainState:
    step: int = 0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random stream of the global step `step` of a run seeded `seed`:
    a resumed run draws what a straight-through run would have drawn."""
    words = np.random.SeedSequence([seed, step]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words[0]) << 31 ^ int(words[1]))
    return gen


class DMTrainer:
    """Owns the FlowDiffusion model and the optimizer.

    Args:
      cfg: the experiment; `cfg.dm_train` holds lr, betas, milestones.
      steps_per_epoch: turns the epoch milestones into step boundaries.
      model: a `FlowDiffusion(..., training=True)` with its frozen LFAE
        weights loaded; built from `cfg` on `device` when None (the CUDA
        card unless `device` says otherwise), with random LFAE weights.
    """

    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int,
                 model: FlowDiffusion | None = None, device=None):
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        if model is None:
            model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
        self.model = model
        self.device = model.device
        self._new_optimizer()

    def _new_optimizer(self) -> None:
        t = self.cfg.dm_train
        self.optimizer = MultistepAdam(
            [p for p in self.model.unet.parameters() if p.requires_grad],
            t.lr, t.adam_betas, t.epoch_milestones, self.steps_per_epoch,
        )

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int | None = None) -> DMTrainState:
        """A fresh run: step 0 and new Adam moments. With `seed`, the UNet
        is re-initialised from it; with None its present weights (a loaded
        checkpoint) are the starting point."""
        if seed is not None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                fresh = build_unet(self.cfg.lfae, self.cfg.diffusion, training=True)
            self.model.unet.load_state_dict(fresh.state_dict())
        self._new_optimizer()
        return DMTrainState(step=0)

    # ------------------------------------------------------------ checkpoint

    def state_dict(self, state: DMTrainState) -> dict:
        """What a resumed run needs (the counterpart of the JAX package's
        `DMTrainState`): the step, the UNet and the Adam moments. The frozen
        LFAE is not in it; a resumed run loads it again from its own source."""
        return {"step": state.step, "unet": self.model.unet.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, saved: dict) -> DMTrainState:
        """Restore a :meth:`state_dict` (e.g. `CheckpointManager.restore(...,
        map_location=trainer.device)`): the UNet, then a new optimizer over
        its parameters, then the saved moments into it, in that order (a new
        optimizer made after the load would start Adam afresh)."""
        self.model.unet.load_state_dict(saved["unet"])
        self._new_optimizer()
        self.optimizer.load_state_dict(saved["optimizer"])
        return DMTrainState(step=int(saved["step"]))

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if v is not None}

    # ------------------------------------------------------------------ step

    def train_step(self, state: DMTrainState, rng: torch.Generator | None, batch: dict,
                   with_monitoring: bool = False, t=None, noise=None, null_mask=None):
        """One optimization step on the diffusion loss. `rng` feeds the
        timestep, noise and null-condition draws unless `t`, `noise` and
        `null_mask` inject them. `with_monitoring` adds the decode of the
        predicted x0 and its reconstruction losses (logging only: the
        gradient does not change).

        Returns `(state, metrics)`: `loss`, `grad_norm`, `lr` (and
        `rec_loss`, `rec_warp_loss`), loss values as 0-d tensors on the
        device."""
        batch = self._to_device(batch)
        self.optimizer.zero_grad()
        loss, aux = self.model.loss(
            batch["ref_img"], batch["real_vid"], batch["cond"], batch.get("none_cond_mask"),
            with_monitoring=with_monitoring, only_use_flow=self.cfg.dm_train.only_use_flow,
            t=t, noise=noise, null_mask=null_mask, generator=rng,
        )
        aux["loss"].backward()
        grads = [p.grad for p in self.model.unet.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        lr = self.optimizer.step(state.step)
        metrics = {"loss": aux["loss"].detach(), "grad_norm": grad_norm, "lr": lr}
        if with_monitoring:
            metrics["rec_loss"] = aux["rec_loss"]
            metrics["rec_warp_loss"] = aux["rec_warp_loss"]
        return DMTrainState(step=state.step + 1), metrics

    # ------------------------------------------------------------------ sample

    @torch.no_grad()
    def monitor(self, state: DMTrainState, rng: torch.Generator | None, batch: dict) -> dict:
        """The monitoring forward on a (small) batch: the aux dict with
        real/fake videos, latent flows and confidences."""
        batch = self._to_device(batch)
        return self.model.loss(
            batch["ref_img"], batch["real_vid"], batch["cond"],
            with_monitoring=True, generator=rng,
        )[1]

    def sample_video(self, state: DMTrainState, rng: torch.Generator | None, sample_img, cond,
                     cond_scale: float = 1.0) -> dict:
        to = lambda a: torch.as_tensor(a).to(self.device)
        return self.model.sample_video(to(sample_img), to(cond), cond_scale, generator=rng)

    # ------------------------------------------------------------------ loop

    def fit(self, state: DMTrainState, batches: Iterator[dict], num_steps: int, seed: int,
            log_every: int = 10, checkpoint_fn=None, checkpoint_every: int = 2000,
            viz_fn=None, viz_every: int = 0, gif_fn=None, gif_every: int = 0,
            sample_fn=None, sample_every: int = 0, start_step: int = 0) -> DMTrainState:
        """Step-count-based loop with periodic hooks `fn(state, batch, step)`
        (`viz_fn`: still-image grid, `gif_fn`: training-batch GIF,
        `sample_fn`: mid-training sample) and `checkpoint_fn(state)`.

        `start_step` resumes: the loop runs only the remaining
        `num_steps - start_step` steps, and step `i` draws from
        `step_generator(seed, i)` whatever step the run started at.
        """
        t0 = time.perf_counter()
        for i in range(start_step, num_steps):
            batch = next(batches)
            for fn, every in ((viz_fn, viz_every), (gif_fn, gif_every), (sample_fn, sample_every)):
                if fn and every and (i + 1) % every == 0:
                    fn(state, batch, i + 1)
            log_now = bool(log_every and (i + 1) % log_every == 0)
            state, metrics = self.train_step(
                state, step_generator(seed, i, self.device), batch, with_monitoring=log_now)
            if log_now:
                dt = time.perf_counter() - t0
                print(
                    f"step {state.step}: loss {float(metrics['loss']):.4f} "
                    f"rec {float(metrics['rec_loss']):.4f} "
                    f"warp {float(metrics['rec_warp_loss']):.4f} ({dt / log_every:.3f}s/step)",
                    flush=True,
                )
                t0 = time.perf_counter()
            if checkpoint_fn and (i + 1) % checkpoint_every == 0:
                checkpoint_fn(state)
        return state

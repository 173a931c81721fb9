"""DM trainer: one loop for MUG/MHAD/NATOPS on one device or over a `data`
mesh of processes (counterpart of `cvpr23_lfdm_tpu/train/dm_trainer.py`).

The trainer owns the model (`FlowDiffusion` in its training form: frozen
LFAE, trainable UNet with fp32 parameters and gradients) and the
optimizer; `DMTrainState` is the step counter that indexes the learning
rate schedule and the per-step random stream. A batch is a dict of numpy
arrays or tensors: `ref_img [B, H, W, 3]`, `real_vid [B, F, H, W, 3]`,
`cond [B, cond_dim]` and optionally `none_cond_mask [B]`.

On a mesh of N ranks (`parallel/mesh.py`) each rank is given its own
contiguous B/N rows of the global batch (the loaders' `host_shard`). It
draws the step's timesteps, noise and null-condition dropout at the
global batch's shape from the step's generator, as one process would, and
keeps its own rows; after `backward` the gradients are averaged over the
ranks before Adam, so every rank takes the one-process step on the global
batch, up to the order of the sums.

On a `data` x `model` mesh (the counterpart of the JAX trainer's
`shard_variables` of the UNet and its Adam moments) the UNet runs in its
tensor-parallel form (`models/unet3d.py::shard_unet`): each rank holds and
updates its shard of the partitioned parameters and their moments. After
`backward` the replicated parameters that a rank uses only on its slice
(GroupNorm affine, the position bias, the time-MLP biases) have their
gradients summed over the model group, then every gradient is averaged
over the data group; `grad_norm` counts each sharded tensor's squares
over the model group and each replicated one once. Checkpoints hold the
one-process format (`gather_variables`), so a tp run and a one-process run
restore each other's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from cvpr23_lfdm_torch.config import ExperimentConfig
from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion, build_unet
from cvpr23_lfdm_torch.models.unet3d import shard_unet, tp_parameters
from cvpr23_lfdm_torch.parallel.mesh import (
    check_device, device_prefetch, gather_variables, local_rows, make_mesh, mean_gradients,
    mean_metrics, replicate, shard_variables, sharded_square_sum, sum_model_gradients,
)
from cvpr23_lfdm_torch.train.optim import MultistepAdam
from cvpr23_lfdm_torch.utils.tracing import span


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
      mesh: the `data` mesh, or a `data` x `model` mesh
        (`parallel/mesh.py::make_mesh`), on the model's device; None: this
        process alone. With a `model` axis the model's UNet is sharded in
        place.
    """

    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int,
                 model: FlowDiffusion | None = None, device=None, mesh=None):
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        if model is None:
            model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device, training=True)
        self.model = model
        self.device = model.device
        self.mesh = make_mesh(1, device=self.device) if mesh is None else mesh
        check_device(self.mesh, self.device)
        shard_unet(model.unet, self.mesh)
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
        checkpoint) are the starting point. On a mesh, rank 0's weights are
        then broadcast to every rank."""
        if seed is not None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                fresh = build_unet(self.cfg.lfae, self.cfg.diffusion, training=True)
            self.model.unet.load_state_dict(shard_variables(fresh.state_dict(), self.mesh))
        self._new_optimizer()
        replicate(self.model, self.mesh)
        return DMTrainState(step=0)

    # ------------------------------------------------------------ checkpoint

    def state_dict(self, state: DMTrainState) -> dict:
        """What a resumed run needs (the counterpart of the JAX package's
        `DMTrainState`): the step, the UNet and the Adam moments. The frozen
        LFAE is not in it; a resumed run loads it again from its own source.
        On a `model` axis the UNet and the moments are gathered into the
        one-process format: every rank calls it."""
        net = self.model.unet
        gather = lambda st, mesh: gather_variables(st, mesh, net.tp_shapes)  # noqa: E731
        return {"step": state.step, "unet": gather(net.state_dict(), self.mesh),
                "optimizer": self._moments(self.optimizer.state_dict(), gather)}

    def _moments(self, saved: dict, fn) -> dict:
        """An optimizer state dict with `fn(state, mesh)` (a
        `gather_variables` or `shard_variables`) applied to each moment,
        keyed by its parameter's name."""
        if self.mesh.model_size == 1:
            return saved
        names = [n for n, p in self.model.unet.named_parameters() if p.requires_grad]
        per_param = {}
        for key in ("exp_avg", "exp_avg_sq"):
            moved = fn({names[i]: s[key] for i, s in saved["state"].items()}, self.mesh)
            for i, s in saved["state"].items():
                per_param.setdefault(i, dict(s))[key] = moved[names[i]]
        return {**saved, "state": per_param}

    def load_state_dict(self, saved: dict) -> DMTrainState:
        """Restore a :meth:`state_dict` (e.g. `CheckpointManager.restore(...,
        map_location=trainer.device)`): the UNet, then a new optimizer over
        its parameters, then the saved moments into it, in that order (a new
        optimizer made after the load would start Adam afresh). On a mesh,
        rank 0's weights and moments are then broadcast to every rank."""
        self.model.unet.load_state_dict(shard_variables(saved["unet"], self.mesh))
        self._new_optimizer()
        self.optimizer.load_state_dict(self._moments(saved["optimizer"], shard_variables))
        replicate(self.model, self.mesh)
        replicate(self.optimizer, self.mesh)
        return DMTrainState(step=int(saved["step"]))

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if v is not None}

    # ------------------------------------------------------------------ step

    def train_step(self, state: DMTrainState, rng: torch.Generator | None, batch: dict,
                   with_monitoring: bool = False, t=None, noise=None, null_mask=None):
        """One optimization step on the diffusion loss. `rng` feeds the
        timestep, noise and null-condition draws unless `t`, `noise` and
        `null_mask` inject them (on a mesh: the global batch's, of which
        this rank keeps its rows). `with_monitoring` adds the decode of the
        predicted x0 and its reconstruction losses (logging only: the
        gradient does not change).

        Returns `(state, metrics)`: `loss`, `grad_norm`, `lr` (and
        `rec_loss`, `rec_warp_loss`), loss values as 0-d tensors on the
        device, averaged over the mesh."""
        with span("train_step", state.step):
            batch = self._to_device(batch)
            if self.mesh.size > 1:
                d = self.cfg.diffusion
                shape = (batch["cond"].shape[0] * self.mesh.size, d.num_frames, d.img_size, d.img_size, 3)
                draws = self.model.diffusion.training_draws(shape, True, rng, self.device, t, noise, null_mask)
                t, noise, null_mask = (local_rows(v, self.mesh) for v in draws)
            self.optimizer.zero_grad()
            loss, aux = self.model.loss(
                batch["ref_img"], batch["real_vid"], batch["cond"], batch.get("none_cond_mask"),
                with_monitoring=with_monitoring, only_use_flow=self.cfg.dm_train.only_use_flow,
                t=t, noise=noise, null_mask=null_mask, generator=rng,
            )
            with span("backward"):
                aux["loss"].backward()
            with span("optimizer"):
                sharded, partial, whole = tp_parameters(self.model.unet)
                sum_model_gradients(partial, self.mesh)
                mean_gradients(self.model.unet.parameters(), self.mesh)
                grad_norm = torch.sqrt(
                    sharded_square_sum([p.grad for p in sharded if p.grad is not None], self.mesh)
                    + sum(torch.linalg.vector_norm(p.grad.float()).square()
                          for p in partial + whole if p.grad is not None))
                lr = self.optimizer.step(state.step)
            metrics = {"loss": aux["loss"].detach(), "grad_norm": grad_norm, "lr": lr}
            if with_monitoring:
                metrics["rec_loss"] = aux["rec_loss"]
                metrics["rec_warp_loss"] = aux["rec_warp_loss"]
            metrics = mean_metrics(metrics, self.mesh, ("loss", "rec_loss", "rec_warp_loss"))
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
        `step_generator(seed, i)` whatever step the run started at. The
        batches go to the device one step ahead (`device_prefetch`); on a
        mesh each is this rank's rows.
        """
        batches = device_prefetch(batches, self.mesh)
        t0 = time.perf_counter()
        for i in range(start_step, num_steps):
            batch = next(batches)
            for fn, every in ((viz_fn, viz_every), (gif_fn, gif_every), (sample_fn, sample_every)):
                if fn and every and (i + 1) % every == 0:
                    fn(state, batch, i + 1)
            log_now = bool(log_every and (i + 1) % log_every == 0)
            state, metrics = self.train_step(
                state, step_generator(seed, i, self.device), batch, with_monitoring=log_now)
            if log_now and self.mesh.rank == 0 and self.mesh.model_rank == 0:
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

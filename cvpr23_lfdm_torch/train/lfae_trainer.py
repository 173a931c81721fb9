"""Stage-1 (LFAE) trainer: reconstruction plus equivariance, on one device
or over a `data` mesh of processes (counterpart of
`cvpr23_lfdm_tpu/train/lfae_trainer.py`).

One step updates the region predictor, the background predictor and the
generator together: Adam (lr 2e-4, betas (0.5, 0.999)) under the epoch
milestones of `cfg.lfae_train`, with BatchNorm in train mode (batch
statistics, running statistics moved as flax moves them). A batch is a dict
of numpy arrays or tensors `source`, `driving`: `[B, H, W, 3]` in [0, 1].

On a mesh of N ranks each rank is given its contiguous B/N rows. The
train-mode BatchNorms take their statistics over every rank's rows
(`models/blocks.py::sync_batchnorm`, the reference's SyncBN), the TPS
transform is drawn for the global batch and each rank keeps its rows, and
the gradients are averaged over the ranks before Adam.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import torch

from cvpr23_lfdm_torch.config import ExperimentConfig
from cvpr23_lfdm_torch.models.blocks import sync_batchnorm
from cvpr23_lfdm_torch.models.flow_autoenc import FlowAE, seed_lfae_weights
from cvpr23_lfdm_torch.parallel.mesh import (
    check_device, device_prefetch, local_rows, make_mesh, mean_gradients, mean_metrics, replicate,
)
from cvpr23_lfdm_torch.train.dm_trainer import step_generator
from cvpr23_lfdm_torch.train.losses import (
    TPSTransform, equivariance_losses, perceptual_pyramid_loss,
)
from cvpr23_lfdm_torch.train.optim import MultistepAdam
from cvpr23_lfdm_torch.train.vgg import Vgg19Features, seed_vgg_weights
from cvpr23_lfdm_torch.utils.bench_ckpt import from_jax_params
from cvpr23_lfdm_torch.utils.device import resolve_device


class LFAEReconstruction(FlowAE):
    """The training forward: the reconstruction of the driving frame, plus
    the region prediction of a TPS-warped driving frame. Its submodules are
    `FlowAE`'s, so the two load the same variables."""

    def forward(self, source: torch.Tensor, driving: torch.Tensor, transform: TPSTransform):
        """Returns `(generated, driving_params, transformed_params)`."""
        source_params = self.region_predictor(source)
        driving_params = self.region_predictor(driving)
        bg_params = self.bg_predictor(source, driving)
        generated = self.generator(source, driving_params, source_params, bg_params)
        transformed_params = self.region_predictor(transform.transform_frame(driving))
        return generated, driving_params, transformed_params


@dataclasses.dataclass
class LFAETrainState:
    step: int = 0


class LFAETrainer:
    """Owns the LFAE (`LFAEReconstruction`, in train mode while it steps),
    the VGG19 of the perceptual loss and the optimizer.

    Args:
      cfg: the experiment; `cfg.lfae` the model, `cfg.lfae_train` the recipe.
      steps_per_epoch: turns the epoch milestones into step boundaries.
      device: the CUDA card unless it says otherwise.
      vgg_seed: the seed of the VGG19's weights (`seed_vgg_weights`; no
        ImageNet weights are downloaded). Weights the user supplies load
        with `trainer.vgg.load_state_dict(convert_torchvision_vgg19(sd))`.
      mesh: the `data` mesh (`parallel/mesh.py::make_mesh`) on `device`;
        None: this process alone.

    The per-step TPS draw comes from `step_generator(seed, step)`, a
    `torch.Generator` seeded with (seed, step): a resumed run replays the
    stream a straight-through run draws. It is not the JAX package's
    `fold_in(rng, step)` stream, which torch cannot reproduce; tests inject
    the same transform into both.
    """

    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int, device=None, vgg_seed: int = 0,
                 mesh=None):
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.device = resolve_device(device)
        self.mesh = make_mesh(1, device=self.device) if mesh is None else mesh
        check_device(self.mesh, self.device)
        self.model = sync_batchnorm(LFAEReconstruction(cfg.lfae).to(self.device), self.mesh.group)
        vgg = Vgg19Features()
        seed_vgg_weights(vgg, vgg_seed)
        self.vgg = replicate(vgg.to(self.device).requires_grad_(False), self.mesh)
        self._new_optimizer()

    def _new_optimizer(self) -> None:
        t = self.cfg.lfae_train
        self.optimizer = MultistepAdam(self.model.parameters(), t.lr, (0.5, 0.999),
                                       t.epoch_milestones, self.steps_per_epoch)

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int | None = None) -> LFAETrainState:
        """A fresh run: step 0 and new Adam moments. With `seed`, the three
        nets are re-initialised from it (`seed_lfae_weights`: seeded
        kernels, identity heads, BatchNorm at its initial values); with None
        their present weights are the starting point. On a mesh, rank 0's
        weights are then broadcast to every rank."""
        if seed is not None:
            fresh = FlowAE(self.cfg.lfae)
            seed_lfae_weights([fresh.region_predictor, fresh.bg_predictor, fresh.generator], seed)
            self.model.load_state_dict(fresh.state_dict())
        self._new_optimizer()
        replicate(self.model, self.mesh)
        return LFAETrainState(step=0)

    def load_state(self, variables: dict) -> LFAETrainState:
        """Warm start from a JAX LFAE variable tree `{"params": ...,
        "batch_stats": ...}` (numpy arrays), through `from_jax_params`."""
        self.model.load_state_dict(from_jax_params(variables))
        self._new_optimizer()
        replicate(self.model, self.mesh)
        return LFAETrainState(step=0)

    # ------------------------------------------------------------ checkpoint

    def state_dict(self, state: LFAETrainState) -> dict:
        """What a resumed run needs: the step, the three nets' parameters
        and BatchNorm statistics, and the Adam moments (the VGG19 is fixed and
        seeded apart)."""
        return {"step": state.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, saved: dict) -> LFAETrainState:
        """Restore a :meth:`state_dict`: the nets, then a new optimizer over
        their parameters, then the saved moments into it; on a mesh, rank
        0's are then broadcast to every rank."""
        self.model.load_state_dict(saved["model"])
        self._new_optimizer()
        self.optimizer.load_state_dict(saved["optimizer"])
        replicate(self.model, self.mesh)
        replicate(self.optimizer, self.mesh)
        return LFAETrainState(step=int(saved["step"]))

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device, torch.float32)
                for k in ("source", "driving")}

    # ------------------------------------------------------------------ step

    def losses(self, rng: torch.Generator | None, source, driving, transform=None):
        """The training forward and its weighted losses. Returns `(losses,
        generated)`; `losses` has `perceptual`, `equivariance_shift` and
        `equivariance_affine`. `transform` (else drawn from `rng`) is the
        global batch's; on a mesh this rank keeps its rows of it."""
        tc = self.cfg.lfae_train
        if transform is None:
            transform = TPSTransform.sample(rng, source.shape[0] * self.mesh.size, tc.sigma_affine,
                                            tc.sigma_tps, tc.points_tps, device=self.device)
        if self.mesh.size > 1:
            cpar = transform.control_params
            transform = TPSTransform(local_rows(transform.theta, self.mesh), transform.control_points,
                                     None if cpar is None else local_rows(cpar, self.mesh))
        generated, driving_params, transformed_params = self.model(source, driving, transform)
        perceptual = perceptual_pyramid_loss(self.vgg, generated["prediction"], driving,
                                             tc.scales, tc.perceptual_weights)
        shift_l, affine_l = equivariance_losses(driving_params, transformed_params, transform,
                                                self.cfg.lfae.revert_axis_swap)
        losses = {"perceptual": perceptual,
                  "equivariance_shift": tc.equivariance_shift_weight * shift_l,
                  "equivariance_affine": tc.equivariance_affine_weight * affine_l}
        return losses, {**generated, "driving_region_params": driving_params,
                        "transformed_region_params": transformed_params}

    def train_step(self, state: LFAETrainState, rng: torch.Generator | None, batch: dict,
                   transform: TPSTransform | None = None):
        """One optimization step. `rng` draws the TPS transform unless
        `transform` injects one (the global batch's). Returns `(state,
        metrics)`: the three losses and `total`, 0-d tensors on the device,
        averaged over the mesh."""
        batch = self._to_device(batch)
        self.model.train()
        self.optimizer.zero_grad()
        losses, _ = self.losses(rng, batch["source"], batch["driving"], transform)
        total = sum(losses.values())
        total.backward()
        mean_gradients(self.model.parameters(), self.mesh)
        self.optimizer.step(state.step)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return LFAETrainState(step=state.step + 1), mean_metrics(metrics, self.mesh, list(metrics))

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def reconstruct(self, state: LFAETrainState, source, driving) -> dict:
        """Self-reconstruction in eval mode (`FlowAE.forward`: running
        statistics; on the card every warp is the `warp_video` kernel)."""
        self.model.eval()
        to = lambda a: torch.as_tensor(a).to(self.device, torch.float32)
        return FlowAE.forward(self.model, to(source), to(driving))

    # ------------------------------------------------------------------ loop

    def fit(self, state: LFAETrainState, batches: Iterator[dict], num_steps: int, seed: int,
            log_every: int = 10, checkpoint_fn=None, checkpoint_every: int = 5000,
            viz_fn=None, viz_every: int = 0, start_step: int = 0) -> LFAETrainState:
        """Step-count-based loop with `viz_fn(state, batch, step)` and
        `checkpoint_fn(state)` hooks. `start_step` resumes: the loop runs only
        the remaining `num_steps - start_step` steps, and step `i` draws from
        `step_generator(seed, i)` whatever step the run started at. The
        batches' `source` and `driving` go to the device one step ahead
        (`device_prefetch`); on a mesh each batch is this rank's rows."""
        batches = device_prefetch(batches, self.mesh, keys=("source", "driving"))
        t0 = time.perf_counter()
        for i in range(start_step, num_steps):
            batch = next(batches)
            if viz_fn and viz_every and (i + 1) % viz_every == 0:
                viz_fn(state, batch, i + 1)
            state, m = self.train_step(state, step_generator(seed, i, self.device), batch)
            if log_every and (i + 1) % log_every == 0 and self.mesh.rank == 0:
                dt = (time.perf_counter() - t0) / log_every
                print(f"lfae step {state.step}: total {float(m['total']):.4f} "
                      f"perc {float(m['perceptual']):.4f} "
                      f"shift {float(m['equivariance_shift']):.4f} "
                      f"affine {float(m['equivariance_affine']):.4f} ({dt:.3f}s/step)", flush=True)
                t0 = time.perf_counter()
            if checkpoint_fn and (i + 1) % checkpoint_every == 0:
                checkpoint_fn(state)
        return state

"""Optimizers and LR schedules of the training recipes (counterpart of
`cvpr23_lfdm_tpu/train/optim.py`)."""

from __future__ import annotations

import torch


def multistep_lr(lr: float, epoch_milestones, steps_per_epoch: int, step: int,
                 gamma: float = 0.1) -> float:
    """The rate of the update with 0-based index `step`: `lr` times `gamma`
    for every milestone whose first step `m * steps_per_epoch` is `<= step`
    (the JAX package's `optax.piecewise_constant_schedule`, read at the
    count before the update: the step that starts a milestone epoch already
    runs at the lower rate)."""
    drops = sum(1 for m in epoch_milestones if step >= int(m) * steps_per_epoch)
    return lr * gamma ** drops


class MultistepAdam:
    """Adam (eps 1e-8 outside the root, no weight decay) under
    :func:`multistep_lr`, the counterpart of `multistep_adam`. `step`
    applies the gradients held by the parameters as the update with the
    given 0-based index."""

    def __init__(self, params, lr: float, betas: tuple[float, float], epoch_milestones,
                 steps_per_epoch: int, gamma: float = 0.1):
        self.lr, self.gamma = lr, gamma
        self.epoch_milestones = tuple(epoch_milestones)
        self.steps_per_epoch = steps_per_epoch
        self.adam = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)

    def lr_at(self, step: int) -> float:
        return multistep_lr(self.lr, self.epoch_milestones, self.steps_per_epoch, step, self.gamma)

    def step(self, step: int) -> float:
        lr = self.lr_at(step)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        return lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Load saved moments. The per-parameter `step` counters go to the
        CPU, where a fresh `torch.optim.Adam` keeps them (`torch.optim`
        leaves them on whatever device the state was restored to)."""
        per_param = {i: {k: v.cpu() if k == "step" else v for k, v in s.items()}
                     for i, s in state["state"].items()}
        self.adam.load_state_dict({**state, "state": per_param})

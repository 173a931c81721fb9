"""The numbers that decide `correct`, and the training readings they are
taken from.

A training cell's set-up drives the program's training step from the seed
through its first `CHECKED_STEPS` steps and keeps, for each: the loss; after
the first, each leaf's gradient norm as the optimizer got it (worked out
from Adam's first moment, `exp_avg / (1 - beta1)`); after the last, each
leaf's change from the seeded weights. The reference follows the same
steps (same weights, rows and draws) with a plain Adam. Norms are compared
leaf by leaf, the gap between the program's norm and the reference's
against the larger of the reference's norm of that leaf and of the median
leaf; the worst leaf is the number. A leaf whose reference gradient is
under a thousandth of the median leaf's moves by round-off alone and is
left out of the change.
"""

from __future__ import annotations

import torch

CHECKED_STEPS = 3
STILL = 1e-3  # of the median leaf's gradient norm


def norms(tensors: dict) -> dict:
    """Per-leaf L2 norms as floats (one host transfer)."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].detach().float()) for n in names]).tolist()
    return dict(zip(names, vals))


def _median(values) -> float:
    return float(torch.tensor(sorted(values)).median())


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's |norm - reference norm| over the larger of its
    reference norm and the median leaf's."""
    med = _median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref}


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref).values())


def training_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of a program's readings against the reference's:
    `loss_gap`, the first step's relative gap; `grad_gap` and
    `change_gap`, the worst leaf's gap of the first gradient and of the
    change; `change_median_gap`, the median leaf's gap of the change. A
    cell's limits file says which of them it compares (`PERF.md` gives the
    readings of the others). The losses of the later checked steps are not
    compared: Adam's first update moves every weight by about the learning
    rate whatever the size of its gradient, so the weights whose gradient
    is at round-off go either way, and the later losses of two sound runs
    part by as much as a lower precision's do."""
    med = _median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= STILL * med]
    change_p = {n: prog["change"][n] for n in moving}
    change_r = {n: ref["change"][n] for n in moving}
    return {
        "loss_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(change_p, change_r),
        "change_median_gap": _median(leaf_gaps(change_p, change_r).values()),
    }


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """`|a - b| / |b|` over all elements."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class PlainAdam:
    """Adam without weight decay, eps outside the root, bias-corrected per
    parameter (a parameter without a gradient is skipped, its count kept):
    the update the recipes state, for the reference."""

    def __init__(self, params: list, lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, tuple(betas), eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = [0] * len(params)

    @torch.no_grad()
    def step(self):
        b1, b2 = self.betas
        for i, (p, m, v) in enumerate(zip(self.params, self.m, self.v)):
            if p.grad is None:
                continue
            self.t[i] += 1
            t = self.t[i]
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            p.sub_(self.lr / (1 - b1 ** t) * m / ((v / (1 - b2 ** t)).sqrt() + self.eps))
            p.grad = None


def _or_zero(t, like):
    return torch.zeros_like(like) if t is None else t


def program_readings(step, named_params: dict, first_moment, beta1: float) -> dict:
    """Drive `step(k)` (returns the step's loss, a 0-d tensor) through the
    checked steps and read the program as the module docstring says.
    `first_moment(p)` is Adam's `exp_avg` of parameter `p` after a step
    (None for one the step left without a gradient)."""
    start = {n: p.detach().clone() for n, p in named_params.items()}
    out = {"loss": []}
    for k in range(CHECKED_STEPS):
        out["loss"].append(float(step(k)))
        if k == 0:
            out["grad"] = norms({n: _or_zero(first_moment(p), p) / (1 - beta1) for n, p in named_params.items()})
    out["change"] = norms({n: p.detach() - start[n] for n, p in named_params.items()})
    return out


def reference_readings(loss_and_backward, named_params: dict, lr: float, betas) -> dict:
    """The reference's readings: `loss_and_backward(k)` computes step k's
    loss, leaves its gradient in the parameters and returns the loss."""
    start = {n: p.detach().clone() for n, p in named_params.items()}
    opt = PlainAdam(list(named_params.values()), lr, betas)
    out = {"loss": []}
    for k in range(CHECKED_STEPS):
        out["loss"].append(float(loss_and_backward(k)))
        if k == 0:
            out["grad"] = norms({n: _or_zero(p.grad, p) for n, p in named_params.items()})
        opt.step()
    out["change"] = norms({n: p.detach() - start[n] for n, p in named_params.items()})
    return out

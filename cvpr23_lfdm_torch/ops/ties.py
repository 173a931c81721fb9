"""Elementwise functions with the JAX package's gradient at a tie.

The port's training path differentiates functions that the JAX package
writes with `jnp.maximum`, `jnp.minimum`, `jnp.clip` and `jnp.abs`. Their
values agree with torch's, but not their gradients where the argument sits
on the kink:

* `jnp.maximum` / `jnp.minimum` (and `jnp.clip`, built from them) give
  each side half the gradient at a tie; `torch.maximum` / `torch.minimum`
  do too, `torch.clamp` and `torch.clamp_min` give all of it to one side;
* `jnp.abs` has the derivative +1 at 0 (`select(x >= 0, g, -g)`), where
  `torch.abs` has 0.
"""

from __future__ import annotations

import torch


def maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """`jnp.maximum(x, v)` for a scalar `v`."""
    return torch.maximum(x, torch.full_like(x, v))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: `minimum(maximum(x, lo), hi)`."""
    return torch.minimum(maximum(x, lo), torch.full_like(x, hi))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """`jnp.abs(x)`, whose derivative at 0 is +1."""
    return torch.where(x >= 0, x, -x)

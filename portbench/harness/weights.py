"""Seeded weights and seeded random streams.

The harness makes every weight and every input itself, on the device, from
`--seed`, and hands the same to the program and to the reference. A
component's weights come from one `randn` call over all its kernels, cut
into views and scaled: N(0, 1 / fan_in) for every conv, dense and
embedding kernel, N(0, 1) for a learned null condition, and the value
the architecture starts from (zero biases, unit norms, the identity heads
of the background predictor) for the rest.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags` under the run's seed
    (any whole number, however large)."""
    words = [int(seed) % (1 << 128), int(seed) // (1 << 128) % (1 << 32)]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *tags, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def _is_kernel(name: str, t: torch.Tensor) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and t.ndim >= 2 and (len(parts) < 2 or parts[-2] not in ("fc", "jacobian"))


def seeded_state(module: nn.Module, seed: int, tag: str, device) -> dict:
    """A state dict for `module` (the reference's, whose names the program
    shares) with its kernels drawn from `(seed, tag)` on `device`."""
    state = module.state_dict()
    drawn = {k: v for k, v in state.items() if _is_kernel(k, v) or k.endswith("null_cond_emb")}
    total = sum(v.numel() for v in drawn.values())
    flat = torch.randn(total, generator=generator(seed, "weights", tag, device=device), device=device)
    out, at = {}, 0
    for k, v in state.items():
        if k in drawn:
            n = v.numel()
            std = 1.0 if k.endswith("null_cond_emb") else (v.shape[0] / n) ** 0.5
            out[k] = (flat[at:at + n] * std).reshape(v.shape)
            at += n
        else:
            out[k] = v.detach().to(device=device, copy=True)
    return out


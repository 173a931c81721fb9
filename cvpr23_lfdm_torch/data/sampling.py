"""Frame-index sampling strategies (a copy of
`cvpr23_lfdm_tpu/data/sampling.py`).

Reference: DM/datasets_mug.py:64-87 (uniform / random / very_random,
short-video edge padding) and LFAE/mug_dataset.py:94 (2-frame pair).
All functions take an explicit `np.random.Generator` — no global RNG.
"""

from __future__ import annotations

import numpy as np


def uniform_indices(total: int, num: int) -> np.ndarray:
    """Evenly spaced indices (datasets_mug.py:67-68)."""
    if total < num:
        return edge_pad_indices(total, num)
    return np.linspace(0, total - 1, num=num, dtype=int)


def random_indices(rng: np.random.Generator, total: int, num: int) -> np.ndarray:
    """Jittered linspace (datasets_mug.py:70-78): each interior anchor moves
    within (1-step_prev, step_next), then sort."""
    if total < num:
        return edge_pad_indices(total, num)
    uniform = np.linspace(0, total - 1, num=num, dtype=int)
    steps = uniform[1:] - uniform[:-1]
    out = uniform.copy()
    for i in range(1, num - 1):
        low = 1 - steps[i - 1]
        high = steps[i]
        if high > low:
            out[i] = out[i] + rng.integers(low, high)
    return np.sort(out)


def very_random_indices(rng: np.random.Generator, total: int, num: int) -> np.ndarray:
    """Sorted with-replacement choice, frame 0 pinned
    (datasets_mug.py:84-87). Applied regardless of video length."""
    idx = np.sort(rng.choice(total, num, replace=True))
    idx[0] = 0
    return idx


def edge_pad_indices(total: int, num: int) -> np.ndarray:
    """Short video: repeat the final frame (datasets_mug.py:79-81)."""
    return np.pad(np.arange(total), (0, num - total), "edge")


def sample_indices(
    rng: np.random.Generator, total: int, num: int, strategy: str
) -> np.ndarray:
    """Dispatch matching the reference's control flow: very_random overrides
    the length check; uniform/random fall back to edge padding."""
    if strategy == "very_random":
        return very_random_indices(rng, total, num)
    if strategy == "uniform":
        return uniform_indices(total, num)
    if strategy == "random":
        return random_indices(rng, total, num)
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def pair_indices(rng: np.random.Generator, total: int) -> np.ndarray:
    """LFAE source/driving pair: 2 sorted with-replacement draws
    (LFAE/mug_dataset.py:94)."""
    return np.sort(rng.choice(total, size=2, replace=True))

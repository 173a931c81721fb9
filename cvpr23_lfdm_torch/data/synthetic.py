"""Synthetic frame-folder corpora + in-memory batches (counterpart of
`cvpr23_lfdm_tpu/data/synthetic.py`; the frames are written by the port's
stdlib PNG writer, `data/io.py::write_png`, in place of imageio).

The real MUG/MHAD/NATOPS corpora are licensed and not present in this
image; these generators produce structurally identical directory trees
(moving-gaussian-blob videos) so the full data pipeline, trainers, and
eval harnesses run end to end. Tests and smoke training use them.
"""

from __future__ import annotations

import os

import numpy as np


def _blob_video(
    rng: np.random.Generator, num_frames: int, size: int, seed_color,
    motion_scale: float = 1.0,
) -> np.ndarray:
    """A colored gaussian blob translating across the frame.

    `motion_scale` scales the travel distance: 1.0 sweeps up to 30% of
    the frame (stress augmentation/warp paths); ~0.2 matches the few-px
    local motion of real MUG facial expressions (the trained-regime
    bench corpus, scripts/make_bench_ckpt.py)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    x0, y0 = rng.uniform(0.2, 0.8, 2)
    vx, vy = rng.uniform(-0.3, 0.3, 2) * motion_scale
    sigma = rng.uniform(0.08, 0.15)
    frames = []
    for f in range(num_frames):
        t = f / max(num_frames - 1, 1)
        cx, cy = x0 + vx * t, y0 + vy * t
        g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
        img = (g[..., None] * np.asarray(seed_color)[None, None]) * 255.0
        frames.append(img.clip(0, 255).astype(np.uint8))
    return np.stack(frames)


def make_synthetic_corpus(
    root: str,
    dataset: str = "mug",
    subjects=None,
    classes=None,
    takes: int = 1,
    num_frames: int = 12,
    size: int = 64,
    seed: int = 0,
    motion_scale: float = 1.0,
) -> None:
    """Write a synthetic frame-folder tree matching `dataset`'s layout."""
    from cvpr23_lfdm_torch.data.io import write_png
    from cvpr23_lfdm_torch.data.specs import SPECS, MUG_SESSION_SUBJECTS

    spec = SPECS[dataset]
    rng = np.random.default_rng(seed)
    subjects = list(subjects if subjects is not None else spec.train_subjects[:2])
    classes = list(classes if classes is not None else spec.classes[:2])

    def write_video(vdir, color):
        os.makedirs(vdir, exist_ok=True)
        vid = _blob_video(rng, num_frames, size, color, motion_scale)
        for i, frame in enumerate(vid):
            write_png(os.path.join(vdir, f"{i:04d}.png"), frame)

    for sub in subjects:
        for ci, cls in enumerate(classes):
            color = rng.uniform(0.3, 1.0, 3)
            for take in range(takes):
                if dataset == "mug":
                    base = (
                        os.path.join(root, str(sub), "session0", cls)
                        if str(sub) in MUG_SESSION_SUBJECTS
                        else os.path.join(root, str(sub), cls)
                    )
                    vdir = os.path.join(base, f"take{take:03d}")
                elif dataset == "mhad":
                    a = spec.classes.index(cls) + 1
                    vdir = os.path.join(root, f"a{a}_s{int(sub)}_t{take + 1}")
                elif dataset == "natops":
                    a = spec.classes.index(cls) + 1
                    vdir = os.path.join(
                        root, f"g{a:02d}s{int(sub):02d}t{take + 1:02d}"
                    )
                else:
                    raise ValueError(dataset)
                write_video(vdir, color)


def synthetic_dm_batches(
    batch_size: int,
    num_frames: int = 40,
    image_size: int = 128,
    cond_dim: int = 768,
    seed: int = 0,
):
    """Infinite in-memory DM batches (for benches / smoke tests without IO)."""
    rng = np.random.default_rng(seed)
    while True:
        vid = rng.random((batch_size, num_frames, image_size, image_size, 3))
        cond = rng.standard_normal((batch_size, cond_dim))
        yield {
            "ref_img": vid[:, 0].astype(np.float32),
            "real_vid": vid.astype(np.float32),
            "cond": cond.astype(np.float32),
        }

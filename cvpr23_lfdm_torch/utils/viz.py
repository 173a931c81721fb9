"""Visualization for the evaluation and training dumps: flow colorization,
confidence maps, warp lattices, grids and GIFs (the part of
`cvpr23_lfdm_tpu/utils/viz.py` that `eval/flowautoenc.py::evaluate` and the
trainers' viz hooks use, copied: that module imports no JAX, and the port
keeps its own copy).

Reference: misc.py:16-80 (grid2fig / conf2fig). The Middlebury/Baker
optical-flow color wheel is implemented here directly (as
`flow_vis.flow_to_color`). `cv2`, `matplotlib` and `imageio` are imported
where they are used; without them those functions raise `ImportError`.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------- optical flow coloring


def _make_colorwheel() -> np.ndarray:
    """Baker et al. flow color wheel (55 x 3 uint8) — the flow_vis wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> uint8 color image (flow_vis.flow_to_color)."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u, v = np.clip(u, 0, clip_flow), np.clip(v, 0, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _COLORWHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _COLORWHEEL[k0, c] / 255.0
        col1 = _COLORWHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img


def conf2fig(conf: np.ndarray, img_size: int = 128) -> np.ndarray:
    """misc.py:76-80: [h, w] or [h, w, 1] confidence in [0,1] -> uint8."""
    import cv2

    conf = np.asarray(conf)
    if conf.ndim == 3:
        conf = conf[..., 0]
    conf = cv2.resize(conf, (img_size, img_size), interpolation=cv2.INTER_NEAREST)
    return (np.clip(conf, 0, 1) * 255).astype(np.uint8)


def grid2fig(warped_grid: np.ndarray, grid_size: int = 32, img_size: int = 128) -> np.ndarray:
    """misc.py:44-63: warp lattice plot (identity lattice in grey, warped in
    blue) rendered to uint8 via matplotlib Agg."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    lin = np.linspace(-1, 1, grid_size)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")

    def plot_lattice(ax, x, y, **kw):
        segs1 = np.stack((x, y), axis=2)
        ax.add_collection(LineCollection(segs1, **kw))
        ax.add_collection(LineCollection(segs1.transpose(1, 0, 2), **kw))
        ax.autoscale()

    fig, ax = plt.subplots()
    plot_lattice(ax, gx, gy, color="lightgrey")
    plot_lattice(ax, warped_grid[..., 0], warped_grid[..., 1], color="C0")
    ax.axis("off")
    fig.tight_layout(pad=0)
    fig.set_size_inches(img_size / 100, img_size / 100)
    fig.set_dpi(100)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


# ------------------------------------------------------------- grids / GIFs


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def tile_grid(rows: list[list[np.ndarray]]) -> np.ndarray:
    """Tile a 2D list of equal-size [H, W, 3] uint8 images (the 5x2 training
    dumps, DM train :252-280)."""
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)


def save_gif(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """frames: [F, H, W, 3] uint8 or float [0,1]."""
    import imageio.v2 as imageio

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = to_uint8(frames)
    imageio.mimsave(path, list(frames), duration=1000.0 / fps, loop=0)

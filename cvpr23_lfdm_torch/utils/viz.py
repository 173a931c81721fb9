"""Visualization: flow colorization, confidence maps, warp lattices, grids,
GIF and PNG files (counterpart of `cvpr23_lfdm_tpu/utils/viz.py`).

Reference: misc.py:16-80 (grid2fig / flow2fig / conf2fig) and the LFAE
`Visualizer` (LFAE/modules/util.py:279-421). The Middlebury/Baker
optical-flow color wheel is implemented here directly (as
`flow_vis.flow_to_color`).

The paths the CLIs take on the card need no `cv2`, `imageio` or
`matplotlib`: `flow2fig` and `conf2fig` resize with the numpy
`data/io.py::resize` (OpenCV's `INTER_AREA` and `INTER_NEAREST`),
`save_gif` is a GIF89a writer over one fixed palette (:func:`quantize`,
LZW codes kept literal with a clear code every 254 codes), and
`save_image` writes PNG (`data/io.py::write_png`). `grid2fig` (the warp
lattice, drawn by matplotlib) and :class:`Visualizer` (its colormap) keep
`matplotlib`, imported where they are used: no CLI of the port calls them
but `eval_flowautoenc --save-video`, which therefore needs matplotlib.
"""

from __future__ import annotations

import struct

import numpy as np

from cvpr23_lfdm_torch.data.io import resize, write_png


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


def flow2fig(warped_grid: np.ndarray, id_grid: np.ndarray, img_size: int = 128) -> np.ndarray:
    """misc.py:66-73: residual flow -> color -> resize (OpenCV `INTER_AREA`)."""
    img = flow_to_color(np.asarray(warped_grid - id_grid))
    return resize(img, (img_size, img_size), "area")


def conf2fig(conf: np.ndarray, img_size: int = 128) -> np.ndarray:
    """misc.py:76-80: [h, w] or [h, w, 1] confidence in [0,1] -> uint8
    (OpenCV `INTER_NEAREST`)."""
    conf = np.asarray(conf)
    if conf.ndim == 3:
        conf = conf[..., 0]
    conf = resize(conf, (img_size, img_size), "nearest")
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


# GIF89a: one global palette of 6 x 7 x 6 RGB levels (252 colours, padded to
# 256 with black); a pixel takes the nearest level per channel.
_LEVELS = (6, 7, 6)
_PALETTE = np.zeros((256, 3), np.uint8)
_PALETTE[:252] = np.stack(np.meshgrid(
    *[np.rint(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS], indexing="ij"), -1).reshape(-1, 3)
_LZW_RUN = 254  # literal codes between clear codes: the 9-bit code width never grows


def _palette_index(frames: np.ndarray) -> np.ndarray:
    """uint8 `[..., 3]` -> palette index `[...]` uint8."""
    q = [np.rint(frames[..., c].astype(np.float32) * ((n - 1) / 255.0)).astype(np.int32)
         for c, n in enumerate(_LEVELS)]
    return ((q[0] * _LEVELS[1] + q[1]) * _LEVELS[2] + q[2]).astype(np.uint8)


def quantize(frames: np.ndarray) -> np.ndarray:
    """The colours :func:`save_gif` stores for uint8 `[..., 3]` frames."""
    return _PALETTE[_palette_index(np.asarray(frames))]


def _lzw_literal(indices: np.ndarray) -> bytes:
    """GIF LZW image data (minimum code size 8, 9-bit codes) holding every
    index as a literal code, a clear code before each run of `_LZW_RUN`,
    then end-of-information; packed LSB first into sub-blocks of <= 255
    bytes."""
    clear, eoi = 256, 257
    flat = indices.reshape(-1).astype(np.uint16)
    runs = np.array_split(flat, max(1, -(-flat.size // _LZW_RUN)))
    codes = np.concatenate([c for r in runs for c in (np.array([clear], np.uint16), r)]
                           + [np.array([eoi], np.uint16)])
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i: i + 255])]) + data[i: i + 255]
                      for i in range(0, len(data), 255))
    return b"\x08" + blocks + b"\x00"


def save_gif(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """frames: [F, H, W, 3] uint8 or float [0,1] -> an animated GIF89a that
    loops forever, each frame shown `round(100 / fps)` centiseconds, its
    colours those of :func:`quantize`."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = to_uint8(frames)
    f, h, w, _ = frames.shape
    delay = int(round(100.0 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for index in _palette_index(frames):
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), _lzw_literal(index)]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def dm_training_gif(
    src_img: np.ndarray,
    real_vid: np.ndarray,
    real_out: np.ndarray,
    real_warp: np.ndarray,
    gen_out: np.ndarray,
    gen_warp: np.ndarray,
    real_grid: np.ndarray,
    gen_grid: np.ndarray,
    real_conf: np.ndarray,
    gen_conf: np.ndarray,
    img_size: int = 128,
) -> np.ndarray:
    """Per-frame 5x2 training-dump tile animation (reference DM train
    :282-318 save_vid / :320-360 sampling layout): columns are
    src|real-out|gen-out|real-grid|real-conf over
    tar|real-warp|gen-warp|gen-grid|gen-conf. Videos `[F, H, W, 3]`,
    grids `[F, h, w, 2]`, confs `[F, h, w, 1]`. Returns `[F, 2H, 5W, 3]`
    uint8 frames for `save_gif`. Draws lattices with `grid2fig`
    (matplotlib)."""
    frames = []
    src = to_uint8(src_img)
    for nf in range(real_vid.shape[0]):
        rows = [
            [
                src,
                to_uint8(real_out[nf]),
                to_uint8(gen_out[nf]),
                grid2fig(real_grid[nf], img_size=img_size),
                np.repeat(conf2fig(real_conf[nf], img_size)[..., None], 3, -1),
            ],
            [
                to_uint8(real_vid[nf]),
                to_uint8(real_warp[nf]),
                to_uint8(gen_warp[nf]),
                grid2fig(gen_grid[nf], img_size=img_size),
                np.repeat(conf2fig(gen_conf[nf], img_size)[..., None], 3, -1),
            ],
        ]
        frames.append(tile_grid(rows))
    return np.stack(frames)


def save_image(path: str, img: np.ndarray) -> None:
    """Write a PNG (uint8, or float [0, 1])."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    write_png(path, img)


# ----------------------------------------------------------- LFAE visualizer


def draw_colored_heatmap(heatmap: np.ndarray, colormap, bg_color) -> np.ndarray:
    """util.py:279-298: blend per-region colors by heatmap mass."""
    parts = []
    weights = []
    bg_color = np.asarray(bg_color).reshape(1, 1, 3)
    num_regions = heatmap.shape[-1]
    for i in range(num_regions):
        color = np.asarray(colormap(i / num_regions))[:3].reshape(1, 1, 3)
        part = heatmap[..., i : i + 1]
        parts.append(part * color)
        weights.append(part)
    weight = sum(weights)
    bg = (1 - weight) * bg_color
    return sum(parts) + bg


class Visualizer:
    """LFAE training board (util.py:301-421): source/driving with region
    centers, deformed image, heatmaps, prediction, occlusion. Its colormap
    is matplotlib's."""

    def __init__(self, kp_size: int = 2, draw_border: bool = True, colormap: str = "gist_rainbow"):
        import matplotlib.pyplot as plt

        self.kp_size = kp_size
        self.draw_border = draw_border
        self.colormap = plt.get_cmap(colormap)

    def draw_shifts(self, image: np.ndarray, shifts: np.ndarray) -> np.ndarray:
        """Mark region centers ((x, y) in [-1, 1]) on an image."""
        image = image.copy()
        h, w = image.shape[:2]
        num = shifts.shape[0]
        for i, (x, y) in enumerate(shifts):
            px = int((x + 1) / 2 * (w - 1))
            py = int((y + 1) / 2 * (h - 1))
            color = np.asarray(self.colormap(i / num))[:3]
            y0, y1 = max(0, py - self.kp_size), min(h, py + self.kp_size + 1)
            x0, x1 = max(0, px - self.kp_size), min(w, px + self.kp_size + 1)
            image[y0:y1, x0:x1] = color
        return image

    def visualize(self, source, driving, out: dict) -> np.ndarray:
        """Build the tiled board for one batch element. All inputs NHWC
        float [0,1]; `out` is the generator output dict."""
        src = np.asarray(source[0])
        dri = np.asarray(driving[0])
        h, w = dri.shape[:2]
        cells = []
        if "driving_region_params" in out:
            shifts = np.asarray(out["driving_region_params"]["shift"][0])
            cells.append(self.draw_shifts(dri, shifts))
        else:
            cells.append(dri)
        if "source_region_params" in out:
            shifts = np.asarray(out["source_region_params"]["shift"][0])
            cells.append(self.draw_shifts(src, shifts))
        else:
            cells.append(src)
        if "deformed" in out:
            cells.append(np.asarray(out["deformed"][0]))
        cells.append(np.asarray(out["prediction"][0]))
        if "occlusion_map" in out:
            occ = np.asarray(out["occlusion_map"][0, ..., 0])
            occ = resize(occ, (h, w), "nearest")
            cells.append(np.repeat(occ[..., None], 3, axis=-1))
        row = np.concatenate([to_uint8(c) for c in cells], axis=1)
        return row

"""Visualization: flow colorization, confidence maps, warp lattices, grids,
GIF and PNG files (counterpart of `cvpr23_lfdm_tpu/utils/viz.py`).

Reference: misc.py:16-80 (grid2fig / flow2fig / conf2fig) and the LFAE
`Visualizer` (LFAE/modules/util.py:279-421). The Middlebury/Baker
optical-flow color wheel is implemented here directly (as
`flow_vis.flow_to_color`).

Nothing here needs `cv2`, `imageio` or `matplotlib`, which the card's
machine lacks: `flow2fig` and `conf2fig` resize with the numpy
`data/io.py::resize` (OpenCV's `INTER_AREA` and `INTER_NEAREST`),
`save_gif` is a GIF89a writer over one fixed palette (:func:`quantize`,
LZW codes kept literal with a clear code every 254 codes), `save_image`
writes PNG (`data/io.py::write_png`), :func:`grid2fig` rasterises the warp
lattice as matplotlib's Agg backend strokes it (:func:`_stroke_outlines`,
:func:`_coverage`, :func:`_blend`), and :class:`Visualizer` takes
`gist_rainbow` from a copy of matplotlib's segment table
(:func:`gist_rainbow`).
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


# The warp lattice as matplotlib 3.10's Agg backend draws the reference's
# figure (misc.py:44-63), read from matplotlib: with the axis off and
# `tight_layout(pad=0)` the axes fill the `img_size / 100`-inch figure at 100
# dpi, so data maps linearly onto the pixels between the autoscaled limits
# (the lattices' extent widened by the 5% margin on each side, y up); a
# `LineCollection` line is 1.5 pt wide (1.5 * 100 / 72 px) with butt caps and
# round joins; a path whose every step is horizontal or vertical (1e-4 px) is
# snapped to whole pixels (even width: `floor(v + 0.5)`); the stroke is
# Agg's outline polygon (agg_math_stroke.h, agg_vcgen_stroke.cpp), filled by
# exact area coverage under the nonzero rule, alpha `floor(256 * coverage)`
# capped at 255, each path blended in turn with integer arithmetic.
MARGIN = 0.05
HALF_WIDTH = 1.5 * 100 / 72 / 2
LIGHTGREY = (211, 211, 211)
C0 = (0x1F, 0x77, 0xB4)
_ARC_STEP = 2 * np.arccos(HALF_WIDTH / (HALF_WIDTH + 0.125))  # a round join's angle step
_MAX_ARC = 8  # interior points of one round join (a whole turn takes 6)


def _xy(v):
    return v[..., 0], v[..., 1]


def _intersect(a, b, c, d):
    """Agg's `calc_intersection` of the lines a-b and c-d (`[..., 2]`):
    the point and whether the lines were not parallel."""
    (ax, ay), (bx, by), (cx, cy), (dx, dy) = _xy(a), _xy(b), _xy(c), _xy(d)
    num = (ay - cy) * (dx - cx) - (ax - cx) * (dy - cy)
    den = (bx - ax) * (dy - cy) - (by - ay) * (dx - cx)
    ok = np.abs(den) >= 1e-30
    return a + (num / np.where(ok, den, 1.0))[..., None] * (b - a), ok


def _joins(v0, v1, v2, len1, len2):
    """Agg's `math_stroke::calc_join` at v1 on the left of v0 -> v1 -> v2
    (round joins, inner miters up to Agg's limit, else an inner bevel): its
    vertices `[..., 2 + _MAX_ARC, 2]` and which of them it emits."""
    w = HALF_WIDTH
    (x0, y0), (x1, y1), (x2, y2) = _xy(v0), _xy(v1), _xy(v2)
    o1 = np.stack((w * (y1 - y0) / len1, -w * (x1 - x0) / len1), -1)
    o2 = np.stack((w * (y2 - y1) / len2, -w * (x2 - x1) / len2), -1)
    p1, p2 = v1 + o1, v1 + o2
    inner = (x2 - x1) * (y1 - y0) - (y2 - y1) * (x1 - x0) > 1e-14
    xi, ok = _intersect(v0 + o1, p1, p2, v2 + o2)
    limit = np.maximum(np.minimum(len1, len2), 1.01 * w)
    miter = inner & ok & (np.hypot(*_xy(xi - v1)) <= limit)
    # an outer join with no visible bevel is one point (Agg's shortcut)
    flat = ~inner & (w - np.hypot(*_xy((o1 + o2) / 2)) < w / 1024)
    arc = ~inner & ~flat
    shape = v1.shape[:-1] + (2 + _MAX_ARC,)
    out = np.broadcast_to(p2[..., None, :], shape + (2,)).copy()
    emit = np.zeros(shape, bool)
    out[..., 0, :] = np.where((miter | (flat & ok))[..., None], xi, p1)
    emit[..., 0] = True
    emit[..., 1] = inner & ~miter  # the bevel's second point, p2
    a1 = np.arctan2(o1[..., 1], o1[..., 0])
    a2 = np.arctan2(o2[..., 1], o2[..., 0])
    a2 = np.where(a1 > a2, a2 + 2 * np.pi, a2)
    n = np.minimum(((a2 - a1) / _ARC_STEP).astype(int), _MAX_ARC)
    i = np.arange(1, _MAX_ARC + 2)
    ang = a1[..., None] + i * ((a2 - a1) / (n + 1))[..., None]
    point = arc[..., None] & (i <= n[..., None])  # the arc's interior points, then p2
    out[..., 1:, :] = np.where(point[..., None], v1[..., None, :] + w * np.stack(
        (np.cos(ang), np.sin(ang)), -1), out[..., 1:, :])
    emit[..., 1:] |= point | (arc[..., None] & (i == n[..., None] + 1))
    return out, emit


def _cap(v0, v1, length):
    """Agg's butt cap at v0 of the segment v0 -> v1: its two points."""
    (x0, y0), (x1, y1) = _xy(v0), _xy(v1)
    dx, dy = HALF_WIDTH * (y1 - y0) / length, HALF_WIDTH * (x1 - x0) / length
    return np.stack((np.stack((x0 - dx, y0 + dy), -1), np.stack((x0 + dx, y0 - dy), -1)), -2)


def _stroke_outlines(v):
    """The stroke outline polygon of each polyline `v[p]` (`[P, N, 2]`, N >=
    2, no repeated point, Agg's pixel coordinates), in the order Agg's `vcgen_stroke` walks it:
    the start cap, the joins forward, the end cap, the joins backward; its
    points on Agg's 1/256-pixel grid. Returns the edges: start points, end
    points and the path of each."""
    p = len(v)
    length = np.hypot(*_xy(np.diff(v, axis=1)))
    fwd, fwd_emit = _joins(v[:, :-2], v[:, 1:-1], v[:, 2:], length[:, :-1], length[:, 1:])
    bwd, bwd_emit = _joins(v[:, 2:], v[:, 1:-1], v[:, :-2], length[:, 1:], length[:, :-1])
    cap = np.ones((p, 2), bool)
    pts = np.concatenate([_cap(v[:, 0], v[:, 1], length[:, 0]), fwd.reshape(p, -1, 2),
                          _cap(v[:, -1], v[:, -2], length[:, -1]), bwd[:, ::-1].reshape(p, -1, 2)], 1)
    emit = np.concatenate([cap, fwd_emit.reshape(p, -1), cap, bwd_emit[:, ::-1].reshape(p, -1)], 1)
    pid = np.broadcast_to(np.arange(p)[:, None], emit.shape)[emit]
    pts = np.rint(pts[emit] * 256) / 256
    nxt = np.arange(1, len(pts) + 1)
    last = np.flatnonzero(np.diff(pid, append=-1) != 0)
    nxt[last] = np.concatenate([[0], last[:-1] + 1])  # each polygon closes on its first point
    return pts, pts[nxt], pid


def _lattice_edges(paths):
    """`_stroke_outlines` of each path, Agg's way with repeated points: a
    point within 1e-14 px of the one before it is dropped, and a path left
    with a single point draws nothing."""
    step = np.hypot(*_xy(np.diff(paths, axis=1))) > 1e-14
    whole = step.all(axis=1)
    edges = [_stroke_outlines(paths[whole]) if whole.any() else (np.zeros((0, 2)),) * 2 + (np.zeros(0, int),)]
    edges[0] = edges[0][:2] + (np.flatnonzero(whole)[edges[0][2]],)
    for i in np.flatnonzero(~whole):
        v = paths[i][np.r_[True, step[i]]]
        if len(v) > 1:
            a, b, _ = _stroke_outlines(v[None])
            edges.append((a, b, np.full(len(a), i)))
    return tuple(np.concatenate(parts) for parts in zip(*edges))


def _coverage(a, b, pid, h: int, w: int):
    """Each path's polygon's coverage of the pixels it touches, as three
    flat arrays (path, pixel `row * w + col`, coverage in (0, 1]): the edges
    a -> b cut where they cross a pixel's side, each piece's signed height
    split between its pixel and the next by where it lies, summed along the
    row; the nonzero rule takes the magnitude, capped at 1."""
    e = len(a)
    lo, hi = np.floor(np.minimum(a, b)), np.ceil(np.maximum(a, b))
    crossings = np.maximum(hi - lo - 1, 0).astype(int)
    ts, ids = [np.zeros(e), np.ones(e)], [np.arange(e), np.arange(e)]
    for axis in (0, 1):
        c = crossings[:, axis]
        eid = np.repeat(np.arange(e), c)
        k = lo[eid, axis] + 1 + np.arange(c.sum()) - np.repeat(np.cumsum(c) - c, c)
        ts.append((k - a[eid, axis]) / (b[eid, axis] - a[eid, axis]))
        ids.append(eid)
    t, eid = np.concatenate(ts), np.concatenate(ids)
    order = np.argsort(eid * 2.0 + t)  # by edge, then along it (t in [0, 1])
    t, eid = t[order], eid[order]
    piece = eid[1:] == eid[:-1]
    eid, t0, t1 = eid[:-1][piece], t[:-1][piece], t[1:][piece]
    q0 = a[eid] + t0[:, None] * (b[eid] - a[eid])
    q1 = a[eid] + t1[:, None] * (b[eid] - a[eid])
    dy = q1[:, 1] - q0[:, 1]
    row = np.floor((q0[:, 1] + q1[:, 1]) / 2).astype(np.int64)
    xm = np.clip((q0[:, 0] + q1[:, 0]) / 2, 0, w)
    col = np.floor(xm).astype(np.int64)
    keep = (dy != 0) & (row >= 0) & (row < h)
    dy, f, col = dy[keep], (xm - col)[keep], col[keep]
    width = w + 2
    line = pid[eid[keep]] * h + row[keep]  # one (path, row)
    cell, area = np.unique(np.concatenate([line * width + col, line * width + col + 1]), return_inverse=True)
    area = np.bincount(area, np.concatenate([dy * (1 - f), dy * f]), minlength=len(cell))
    # the running sum along each (path, row); it holds from a cell to the next
    line, col = np.divmod(cell, width)
    total = np.cumsum(area)
    first = np.r_[True, line[1:] != line[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(cell)), 0))
    cov = np.minimum(np.abs(total - total[start] + area[start]), 1.0)
    last = np.r_[~first[1:], False]
    span = np.where(last, np.r_[col[1:], 0] - col, 1)
    span = np.minimum(span, np.maximum(w - col, 0))
    cov, line, col = np.repeat(cov, span), np.repeat(line, span), np.repeat(col, span)
    col = col + np.arange(len(col)) - np.repeat(np.cumsum(span) - span, span)
    on = cov >= 1.0 / 256  # below this Agg's coverage is 0
    path, row = np.divmod(line[on], h)
    return path, row * w + col[on], cov[on]


def _blend(img: np.ndarray, cover, colors: np.ndarray) -> np.ndarray:
    """Blend each path's coverage (`_coverage`) of its colour (`colors[path]`)
    over `img` (uint8 `[h, w, 3]`, opaque) in the order of the paths, in the
    integers of Agg's plain RGBA blender; a pixel only meets the paths that
    cover it."""
    path, pix, cov = cover
    order = np.lexsort((path, pix))
    path, pix, cov = path[order], pix[order], cov[order]
    first = np.r_[True, pix[1:] != pix[:-1]]
    rank = np.arange(len(pix)) - np.maximum.accumulate(np.where(first, np.arange(len(pix)), 0))
    # the r-th path over each pixel, for r = 0, 1, ...: one contiguous block each
    order = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[order], np.arange(int(rank.max(initial=-1)) + 2))
    path, pix, cov = path[order], pix[order], cov[order]
    al = np.minimum(np.floor(cov * 256), 255).astype(np.int64)[:, None]
    c = np.asarray(colors, np.int64)[path]
    out = img.reshape(-1, 3).astype(np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        p, a = pix[lo:hi], al[lo:hi]
        cur = out[p] * 255
        out[p] = ((c[lo:hi] * 256 - cur) * a + cur * 256) // (a + 65280)
    return out.reshape(img.shape).astype(np.uint8)


def grid2fig(warped_grid: np.ndarray, grid_size: int = 32, img_size: int = 128) -> np.ndarray:
    """misc.py:44-63: the warp lattice (the identity lattice in light grey
    under the warped one in C0) as uint8 `[img_size, img_size, 3]`, drawn as
    matplotlib's Agg backend draws the reference's figure: the data limits
    are both lattices' extent widened by the autoscale margin, each row and
    column of a lattice one stroked polyline (rows, then columns; grey, then
    C0), straight ones snapped to whole pixels."""
    lin = np.linspace(-1, 1, grid_size)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    ident = np.stack((gx, gy), -1)
    warped = np.asarray(warped_grid, np.float64)[..., :2]
    pts = np.concatenate([ident.reshape(-1, 2), warped.reshape(-1, 2)])
    lo, hi = pts.min(0), pts.max(0)
    lo, hi = lo - MARGIN * (hi - lo), hi + MARGIN * (hi - lo)
    s = img_size
    edges, colors = [], []
    for lattice, color in ((ident, LIGHTGREY), (warped, C0)):
        x = (lattice[..., 0] - lo[0]) / (hi[0] - lo[0]) * s
        y = s - (lattice[..., 1] - lo[1]) / (hi[1] - lo[1]) * s  # rows run down
        pix = np.stack((x, y), -1)
        for paths in (pix, pix.transpose(1, 0, 2)):
            step = np.abs(np.diff(paths, axis=1))
            straight = np.all((step[..., 0] < 1e-4) | (step[..., 1] < 1e-4), axis=1)
            paths = np.where(straight[:, None, None], np.floor(paths + 0.5), paths)
            a, b, pid = _lattice_edges(paths)
            edges.append((a, b, pid + len(colors)))  # the paths in drawing order
            colors += [color] * len(paths)
    cover = _coverage(*(np.concatenate(e) for e in zip(*edges)), s, s)
    img = _blend(np.full((s, s, 3), 255, np.uint8), cover, np.array(colors))
    return img


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
    uint8 frames for `save_gif`."""
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


# matplotlib's `gist_rainbow` (matplotlib/_cm.py): (x, (r, g, b)) stops,
# linear between them, sampled into a 256-entry table as
# `colors._create_lookup_table` samples it
_GIST_RAINBOW = ((0.0, (1.0, 0.0, 0.16)), (0.03, (1.0, 0.0, 0.0)), (0.215, (1.0, 1.0, 0.0)),
                 (0.4, (0.0, 1.0, 0.0)), (0.586, (0.0, 1.0, 1.0)), (0.77, (0.0, 0.0, 1.0)),
                 (0.954, (1.0, 0.0, 1.0)), (1.0, (1.0, 0.0, 0.75)))


def _colormap_lut(stops, n: int = 256) -> np.ndarray:
    x = np.array([p for p, _ in stops]) * (n - 1)
    y = np.array([c for _, c in stops], np.float64)
    at = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, at)[1:-1]
    dist = (at[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    return np.clip(np.concatenate([y[:1], dist[:, None] * (y[ind] - y[ind - 1]) + y[ind - 1], y[-1:]]), 0, 1)


_GIST_RAINBOW_LUT = _colormap_lut(_GIST_RAINBOW)


def gist_rainbow(x) -> np.ndarray:
    """RGBA of matplotlib's `colormaps["gist_rainbow"](x)` for x in [0, 1]
    (a scalar or an array): the table entry `int(256 x)`, 1 -> the last."""
    n = len(_GIST_RAINBOW_LUT)
    i = np.clip(np.asarray(x, np.float64) * n, 0, n - 1).astype(int)
    rgb = _GIST_RAINBOW_LUT[i]
    return np.concatenate([rgb, np.ones(rgb.shape[:-1] + (1,))], -1)


class Visualizer:
    """LFAE training board (util.py:301-421): source/driving with region
    centers, deformed image, heatmaps, prediction, occlusion. Its colormap
    is matplotlib's `gist_rainbow` (:func:`gist_rainbow`)."""

    def __init__(self, kp_size: int = 2, draw_border: bool = True, colormap: str = "gist_rainbow"):
        if colormap != "gist_rainbow":
            raise ValueError(f"colormap {colormap!r}: only gist_rainbow is carried")
        self.kp_size = kp_size
        self.draw_border = draw_border
        self.colormap = gist_rainbow

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

"""Host-side image IO and the reference's aspect-preserving pad-resize
(counterpart of `cvpr23_lfdm_tpu/data/io.py`), with no `cv2`, `imageio` or
PIL on the paths the card runs.

Reference: misc.py:96-110 (`resize`) — scale so the LONG side equals
`desired_size` (aspect preserved), then zero-pad the short side centered.
Used identically by the LFAE pair datasets (LFAE/mug_dataset.py:14-28)
and the DM video datasets (DM/datasets_mug.py:108).

* :func:`resize` is OpenCV's `cv2.resize` in numpy: `area` (fractional box
  weights on a downscale; on an upscale OpenCV's own bilinear coefficients
  for `INTER_AREA`), `linear` (half-pixel bilinear, edge-clamped) and
  `nearest`. Each is separable: one weight matrix per axis.
* :func:`read_image` decodes PNG with the standard library (`zlib`; the five
  filter types; 8- and 16-bit grey, grey+alpha, RGB, RGBA and 8-bit
  palette; non-interlaced) into what `cv2.imread(IMREAD_COLOR)` gives
  (RGB order here; alpha dropped, grey replicated, 16-bit -> high byte).
  Other formats (the datasets' JPEG frames) and other PNG variants go
  through `cv2` or `imageio` where they are importable, else raise an
  `ImportError` that names the format.
* :func:`write_png` is a stdlib PNG writer (each row filtered `Up`).
"""

from __future__ import annotations

import functools
import math
import os
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

# ---------------------------------------------------------------- cache
#
# Process-wide LRU of decoded frames, as in the JAX package. Budget via
# LFDM_IMAGE_CACHE_MB (default 2048; 0 disables). Cached arrays are marked
# read-only — every consumer copies (stack/resize/astype) before writing.

_CACHE_LOCK = threading.Lock()
_IMAGE_CACHE: "OrderedDict[str, np.ndarray]" = OrderedDict()
_IMAGE_CACHE_BYTES = 0


def _cache_limit_bytes() -> int:
    return int(float(os.environ.get("LFDM_IMAGE_CACHE_MB", "2048")) * 2**20)


def clear_image_cache() -> None:
    global _IMAGE_CACHE_BYTES
    with _CACHE_LOCK:
        _IMAGE_CACHE.clear()
        _IMAGE_CACHE_BYTES = 0


# ---------------------------------------------------------------- resize


def _read_only(fn):
    """Cache a weight table; its arrays are shared, so made read-only."""
    @functools.lru_cache(maxsize=64)
    def cached(*args):
        w = fn(*args)
        w.flags.writeable = False
        return w

    return cached


@_read_only
def _linear_weights(ssize: int, dsize: int, area_mode: bool) -> np.ndarray:
    """`[dsize, ssize]` bilinear weights of one axis as OpenCV's generic
    resize computes them (resize.cpp: `fx` in float32; in `area_mode`
    `sx = floor(dx*scale)`, `fx = (dx+1) - (sx+1)/scale` wrapped to
    [0, 1)); a source index off either edge takes the edge pixel alone."""
    scale = 1.0 / (dsize / ssize)
    inv = dsize / ssize
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        if area_mode:
            sx = math.floor(dx * scale)
            fx = float(np.float32((dx + 1) - (sx + 1) * inv))
            fx = 0.0 if fx <= 0 else float(np.float32(fx - math.floor(fx)))
        else:
            f = np.float32((dx + 0.5) * scale - 0.5)
            sx = math.floor(f)
            fx = float(np.float32(f - sx))
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= ssize - 1:
            sx, fx = ssize - 1, 0.0
        w[dx, sx] += 1.0 - fx
        if fx:
            w[dx, sx + 1] += fx
    return w


@_read_only
def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """`[dsize, ssize]` box weights of a downscale by `ssize / dsize` >= 1:
    OpenCV's `computeResizeAreaTab` (fractional overlap over the cell width;
    float32 weights)."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += float(np.float32((sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            w[dx, sx] += float(np.float32(1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += float(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))
    return w


def resize(im: np.ndarray, size: tuple[int, int], interpolation: str = "area") -> np.ndarray:
    """`cv2.resize(im, (w, h), interpolation=INTER_{AREA,LINEAR,NEAREST})`
    for `size = (h, w)`; `im` `[H, W]` or `[H, W, C]`, uint8 (rounded and
    saturated) or float (float32 out). The shape's rank is kept."""
    h, w = size
    sh, sw = im.shape[:2]
    src = np.asarray(im)
    if interpolation == "nearest":
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
        return src[ys][:, xs].copy()
    if interpolation in ("area", "linear") and src.dtype == np.uint8 and (sh, sw) == (2 * h, 2 * w):
        # OpenCV's integer-scale fast path, which it also takes for a linear
        # halving: (sum of the 2x2 block + 2) >> 2
        s = src.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    if interpolation == "area" and sh >= h and sw >= w:
        wy, wx = _area_weights(sh, h), _area_weights(sw, w)
    elif interpolation in ("area", "linear"):
        area_mode = interpolation == "area"
        wy, wx = _linear_weights(sh, h, area_mode), _linear_weights(sw, w, area_mode)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    x = src.astype(np.float64).reshape(sh, sw, -1)
    c = x.shape[2]
    cols = (x.transpose(0, 2, 1) @ wx.T).reshape(sh, c * w)  # [sh, C, w]
    out = (wy @ cols).reshape(h, c, w).transpose(0, 2, 1).reshape((h, w) + src.shape[2:])
    if src.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def pad_resize(im: np.ndarray, desired_size: int, interpolation: str = "area") -> np.ndarray:
    """Aspect-pad resize (misc.py:96-110). `im`: [H, W, C]; the dtype is kept."""
    old_size = im.shape[:2]
    ratio = float(desired_size) / max(old_size)
    new_size = tuple(int(x * ratio) for x in old_size)
    im = resize(im, new_size, interpolation)
    delta_w = desired_size - new_size[1]
    delta_h = desired_size - new_size[0]
    top, left = delta_h // 2, delta_w // 2
    out = np.zeros((desired_size, desired_size) + im.shape[2:], im.dtype)
    out[top: top + new_size[0], left: left + new_size[1]] = im
    return out


# ---------------------------------------------------------------- PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


class _UnsupportedPNG(ValueError):
    pass


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> `[h, stride]` uint8."""
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per byte lane
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            f, up = line.tolist(), prev.tolist()
            c = [0] * stride
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (f[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    b = up[i]
                    cc = up[i - bpp] if i >= bpp else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                    c[i] = (f[i] + pred) & 0xFF
            cur = np.array(c, np.uint8)
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> uint8 `[H, W, 3]` RGB, as
    `cv2.imread(IMREAD_COLOR)` reads it (alpha dropped, grey replicated, a
    16-bit sample's high byte). Raises `_UnsupportedPNG` for interlaced
    files and bit depths below 8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or ctype not in _PNG_CHANNELS or (ctype == 3 and depth != 8):
        raise _UnsupportedPNG(f"PNG colour type {ctype}, depth {depth}, interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    nbytes = depth // 8
    bpp = ch * nbytes
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp).reshape(h, w, ch, nbytes)
    px = px[..., 0]  # 16-bit: the big-endian high byte
    if ctype == 3:
        return plte[px[..., 0]]
    if ch <= 2:  # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 `[H, W]` (grey) or `[H, W, C]` (C = 1 grey, 2 grey+alpha,
    3 RGB, 4 RGBA) as an 8-bit non-interlaced PNG, every row filtered `Up`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png: uint8 expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c)
    up = rows - np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])  # wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------- read


def read_image(path: str) -> np.ndarray:
    """Read an image file to uint8 [H, W, 3] RGB, LRU-cached decoded.
    Returned cached arrays are READ-ONLY — copy before writing (all in-tree
    consumers already do)."""
    global _IMAGE_CACHE_BYTES

    limit = _cache_limit_bytes()
    if limit > 0:
        with _CACHE_LOCK:
            img = _IMAGE_CACHE.get(path)
            if img is not None:
                _IMAGE_CACHE.move_to_end(path)
                return img
    img = _read_image_uncached(path)
    if limit > 0 and img.nbytes <= limit:
        img.flags.writeable = False
        with _CACHE_LOCK:
            if path not in _IMAGE_CACHE:
                _IMAGE_CACHE[path] = img
                _IMAGE_CACHE_BYTES += img.nbytes
                while _IMAGE_CACHE_BYTES > limit:
                    _, old = _IMAGE_CACHE.popitem(last=False)
                    _IMAGE_CACHE_BYTES -= old.nbytes
    return img


def _read_image_uncached(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        try:
            return decode_png(data)
        except _UnsupportedPNG as e:
            what = str(e)
    else:
        what = os.path.splitext(path)[1].lstrip(".").upper() or "this image format"
    return _read_with_library(path, what)


def _read_with_library(path: str, what: str) -> np.ndarray:
    """Decode through cv2 (EXIF orientation ignored, as the reference's
    imageio read) or imageio, whichever is importable."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is not None:
            return np.ascontiguousarray(img[:, :, ::-1])
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise ImportError(
            f"reading {what} ({path}) needs cv2 or imageio, and neither is installed; "
            f"the port decodes PNG (8/16-bit, non-interlaced) without them") from None
    img = np.asarray(imageio.imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def list_frames(video_dir: str) -> list[str]:
    """Sorted jpg/png frame paths of a frame-folder video
    (DM/datasets_mug.py:60-63)."""
    names = sorted(
        x for x in os.listdir(video_dir) if x.endswith(("jpg", "png", "jpeg"))
    )
    return [os.path.join(video_dir, n) for n in names]

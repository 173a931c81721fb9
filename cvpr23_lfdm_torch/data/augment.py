"""Host-side clip augmentation in pure numpy (a copy of
`cvpr23_lfdm_tpu/data/augment.py`; `resize_clip` uses the port's numpy
`data/io.py::resize` in place of `cv2`).

Reference: LFAE/augmentation.py (torch_videovision transforms applied to a
clip = list of frames sharing one random draw) and the DM datasets' inline
color jitter (DM/datasets_mug.py:93-105). The torchvision `adjust_*`
semantics are reimplemented in float:

  brightness: img * f
  contrast:   f * img + (1 - f) * mean(gray(img))
  saturation: f * img + (1 - f) * gray(img)
  hue:        HSV hue rotated by f (f in [-0.5, 0.5])

All functions operate on float32 arrays in [0, 1] shaped [H, W, 3] (or a
clip [F, H, W, 3]); each takes an explicit `np.random.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cvpr23_lfdm_torch.data.io import resize

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601-2 (PIL "L")


def adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return np.clip(img * f, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    # per-frame mean gray: the reference jitters frames individually
    # (PIL images, DM/datasets_mug.py:102-105), so a clip [F, H, W, 3]
    # blends each frame against its own mean
    mean = (img @ _GRAY).mean(axis=(-2, -1), keepdims=True)[..., None]
    return np.clip(f * img + (1.0 - f) * mean, 0.0, 1.0)


def adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    gray = (img @ _GRAY)[..., None]
    return np.clip(f * img + (1.0 - f) * gray, 0.0, 1.0)


def _rgb_to_hsv(img: np.ndarray):
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    safe = np.maximum(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
    )
    return out


def adjust_hue(img: np.ndarray, f: float) -> np.ndarray:
    h, s, v = _rgb_to_hsv(img)
    h = (h + f) % 1.0
    return np.clip(_hsv_to_rgb(h, s, v), 0.0, 1.0).astype(np.float32)


def color_jitter_clip(
    rng: np.random.Generator,
    clip: np.ndarray,
    brightness: float,
    contrast: float,
    saturation: float,
    hue: float,
    shuffle_order: bool = True,
) -> np.ndarray:
    """One factor draw shared by every frame (augmentation.py:261-293,
    DM/datasets_mug.py:93-105). The LFAE path shuffles the op order
    (augmentation.py:282); the DM path uses fixed B,C,S,H order
    (`shuffle_order=False`)."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x, f=f: adjust_brightness(x, f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x, f=f: adjust_contrast(x, f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda x, f=f: adjust_saturation(x, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda x, f=f: adjust_hue(x, f))
    if shuffle_order:
        order = rng.permutation(len(ops))
        ops = [ops[i] for i in order]
    out = clip
    for op in ops:
        out = op(out)
    return out.astype(np.float32)


# ------------------------------------------------------ geometric transforms


def resize_clip(clip: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize every frame to `(h, w)` (augmentation.py:122-138 resize_clip).

    The reference uses skimage `resize(order=1, anti_aliasing=True)`;
    here OpenCV's `INTER_AREA` for downscale (box anti-aliasing) and
    `INTER_LINEAR` for upscale, as the JAX package, through the numpy
    `data/io.py::resize`.
    """
    h, w = size
    f = clip.shape[0]
    interp = "area" if h < clip.shape[1] or w < clip.shape[2] else "linear"
    out = np.empty((f, h, w, clip.shape[3]), np.float32)
    for i in range(f):
        out[i] = resize(np.asarray(clip[i], np.float32), (h, w), interp)
    return out


def random_resize_clip(
    rng: np.random.Generator,
    clip: np.ndarray,
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """RandomResize (augmentation.py:105-133): one scale factor drawn
    uniformly from `ratio`, applied to the whole clip (floor to int)."""
    s = rng.uniform(ratio[0], ratio[1])
    _, im_h, im_w, _ = clip.shape
    return resize_clip(clip, (int(im_h * s), int(im_w * s)))


def pad_clip(clip: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-pad a clip up to at least (h, w), centered
    (augmentation.py:113-118 pad_clip): pads ONLY when the target is >=
    the image extent (the reference's `h < im_h` gate)."""
    im_h, im_w = clip.shape[1:3]
    pad_h = (0, 0) if h < im_h else ((h - im_h) // 2, (h - im_h + 1) // 2)
    pad_w = (0, 0) if w < im_w else ((w - im_w) // 2, (w - im_w + 1) // 2)
    return np.pad(clip, ((0, 0), pad_h, pad_w, (0, 0)), mode="edge")


def random_crop_clip(
    rng: np.random.Generator, clip: np.ndarray, size: int | tuple[int, int]
) -> np.ndarray:
    """RandomCrop (augmentation.py:136-172): edge-pad to fit, then one
    shared crop window. Reproduces the reference's quirk of gating each
    offset on the OTHER axis' exact-fit check (`x1 = 0 if h == im_h`),
    and `random.randint`'s inclusive upper bound."""
    h, w = (size, size) if isinstance(size, int) else size
    clip = pad_clip(clip, h, w)
    im_h, im_w = clip.shape[1:3]
    x1 = 0 if h == im_h else int(rng.integers(0, im_w - w + 1))
    y1 = 0 if w == im_w else int(rng.integers(0, im_h - h + 1))
    return clip[:, y1 : y1 + h, x1 : x1 + w, :]


def rotate_clip(clip: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate every frame by `angle_deg` (counter-clockwise) about the
    pixel-center of the frame, bilinear, zero fill — skimage
    `rotate(img, angle, preserve_range=True)` semantics
    (augmentation.py:199-204)."""
    f, h, w, c = clip.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    # inverse map: output pixel -> source coordinate (rotate by -angle)
    sx = cos * (xx - cx) - sin * (yy - cy) + cx
    sy = sin * (xx - cx) + cos * (yy - cy) + cy
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)

    flat = clip.reshape(f, h * w, c)

    def corner(yi, xi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = (np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)).ravel()
        g = flat[:, lin, :].reshape(f, h, w, c)
        return g * (wgt * valid)[None, :, :, None]

    out = corner(y0, x0, (1 - fx) * (1 - fy))
    out += corner(y0, x0 + 1, fx * (1 - fy))
    out += corner(y0 + 1, x0, (1 - fx) * fy)
    out += corner(y0 + 1, x0 + 1, fx * fy)
    return out.astype(np.float32)


def random_rotate_clip(
    rng: np.random.Generator,
    clip: np.ndarray,
    degrees: float | tuple[float, float],
) -> np.ndarray:
    """RandomRotation (augmentation.py:175-213): one angle per clip."""
    if isinstance(degrees, (int, float)):
        if degrees < 0:
            raise ValueError("single-number degrees must be positive")
        degrees = (-degrees, degrees)
    angle = rng.uniform(degrees[0], degrees[1])
    return rotate_clip(clip, angle)


@dataclasses.dataclass(frozen=True)
class ClipAugment:
    """Composed clip augmentation (AllAugmentationTransform,
    augmentation.py:323-345) in the reference's application order:
    flip -> rotation -> resize -> crop -> jitter. MUG/MHAD/NATOPS configs
    enable flips + jitter only (config/mug128.yaml:28-36), so the
    geometric transforms default to off."""

    time_flip: bool = True
    horizontal_flip: bool = True
    rotation_degrees: float | tuple[float, float] | None = None
    resize_ratio: tuple[float, float] | None = None
    crop_size: int | tuple[int, int] | None = None
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.1

    def __call__(self, rng: np.random.Generator, clip: np.ndarray) -> np.ndarray:
        """clip: [F, H, W, 3] float32 in [0, 1]."""
        # reference's if/elif: a time flip suppresses the horizontal check
        if self.time_flip and rng.random() < 0.5:
            clip = clip[::-1]
        elif self.horizontal_flip and rng.random() < 0.5:
            clip = clip[:, :, ::-1]
        if self.rotation_degrees is not None:
            clip = random_rotate_clip(
                rng, np.ascontiguousarray(clip), self.rotation_degrees
            )
        if self.resize_ratio is not None:
            clip = random_resize_clip(
                rng, np.ascontiguousarray(clip), self.resize_ratio
            )
        if self.crop_size is not None:
            clip = random_crop_clip(rng, clip, self.crop_size)
        if self.brightness or self.contrast or self.saturation or self.hue:
            clip = color_jitter_clip(
                rng, np.ascontiguousarray(clip),
                self.brightness, self.contrast, self.saturation, self.hue,
                shuffle_order=True,
            )
        return np.ascontiguousarray(clip)

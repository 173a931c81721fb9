"""ctypes bindings for the native C++ data path `native/lfdm_data.cc`
(counterpart of `cvpr23_lfdm_tpu/data/native.py`, which binds the same
source).

The library is built on first use with `g++` into the port's build
directory (`cvpr23_lfdm_torch/build/liblfdm_data-<hash>.so`; the
committed `native/liblfdm_data.so` belongs to the JAX package and is never
written). It is built for the baseline of the architecture, not with the
JAX build's `-march=native`, so a checkout copied to another host never
loads instructions that host lacks; the two builds may round apart in the
last bit (fused multiply-adds). This is host code, not a kernel: where no
compiler is found, or with `LFDM_NATIVE=0`, every entry point takes its
numpy path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "lfdm_data.cc")
_BUILD = os.path.join(_REPO_ROOT, "cvpr23_lfdm_torch", "build")

_lock = threading.Lock()
_lib = None
_tried = False


_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _lib_path() -> str:
    """The library's path, keyed by a hash of the source and the flags."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"liblfdm_data-{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)  # atomic: concurrent builds each write their own tmp
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("LFDM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.isfile(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pad_resize_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ]
        lib.jitter_bcs_f32.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.pad_resize_batch_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.pad_resize_batch_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def pad_resize_batch(frames_u8: np.ndarray, size: int, num_threads: int = 4) -> np.ndarray:
    """uint8 [F, H, W, C] -> float32 [F, size, size, C] in [0, 1]
    (misc.py:96-110 semantics). Native threaded path with numpy fallback."""
    lib = get_lib()
    f, h, w, c = frames_u8.shape
    if lib is None:
        from cvpr23_lfdm_torch.data.io import pad_resize

        out = np.stack([pad_resize(fr, size) for fr in frames_u8])
        return out.astype(np.float32) / 255.0
    frames_u8 = np.ascontiguousarray(frames_u8)
    out = np.empty((f, size, size, c), np.float32)
    lib.pad_resize_batch_u8(
        frames_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        f, h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, num_threads,
    )
    return out


def pad_resize_batch_f32(frames: np.ndarray, size: int, num_threads: int = 4) -> np.ndarray:
    """float32 [F, H, W, C] in [0,1] -> float32 [F, size, size, C]."""
    lib = get_lib()
    f, h, w, c = frames.shape
    if lib is None:
        from cvpr23_lfdm_torch.data.io import pad_resize

        return np.stack([pad_resize(np.asarray(fr, np.float32), size) for fr in frames]).astype(np.float32)
    frames = np.ascontiguousarray(frames, np.float32)
    out = np.empty((f, size, size, c), np.float32)
    lib.pad_resize_batch_f32(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, num_threads,
    )
    return out


def jitter_bcs(clip: np.ndarray, fb: float, fc: float, fs: float) -> np.ndarray:
    """In-place brightness/contrast/saturation over [F, H, W, 3] float [0,1]."""
    lib = get_lib()
    if lib is None:
        from cvpr23_lfdm_torch.data.augment import (
            adjust_brightness, adjust_contrast, adjust_saturation,
        )

        return adjust_saturation(
            adjust_contrast(adjust_brightness(clip, fb), fc), fs
        ).astype(np.float32)
    clip = np.ascontiguousarray(clip, np.float32)
    f = clip.shape[0]
    px = int(np.prod(clip.shape[1:-1]))
    lib.jitter_bcs_f32(
        clip.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f, px, fb, fc, fs,
    )
    return clip

"""Build the CUDA kernels under `csrc/` with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (`extern "C"` launch
functions that take raw pointers, sizes and a stream, and return
`cudaGetLastError()`), so it compiles in seconds without PyTorch's headers.
A library is built at its first use into `cvpr23_lfdm_torch/build/`, named
after a hash of its source so an edited source is rebuilt, and is loaded
once per process. A kernel that does not build raises.

A source can be built under preprocessor defines (`-D<NAME>`): each set of
defines is a library of its own, keyed by the defines as well, so the
ablation variants of one source live beside its plain build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str, defines: tuple[str, ...] = ()) -> str:
    """Library path, keyed by the source, the shared headers, the flags and
    the preprocessor defines."""
    h = hashlib.sha1(" ".join([*NVCC_FLAGS, *(f"-D{d}" for d in defines)]).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for n in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, n), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, defines: tuple[str, ...] = ()) -> tuple[subprocess.Popen, str, str] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _target(name, defines)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started, defines: tuple[str, ...] = ()) -> str:
    if started is None:  # built before: its saved nvcc output
        log = _target(name, defines)[: -len(".so")] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                return f.read()
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(names: list) -> dict:
    """Build the named kernels, one `nvcc` per library, all started together.
    An entry is a source name or `(name, (define, ...))`. Returns
    `{"seconds": wall time, "logs": {label: nvcc output}}` (the `-Xptxas -v`
    register and shared-memory report; for a library built before, the
    output saved beside it), a variant labelled `name[defines]`."""
    t0 = time.perf_counter()
    jobs = [(n, ()) if isinstance(n, str) else (n[0], tuple(n[1])) for n in names]
    label = lambda n, d: n if not d else f"{n}[{','.join(d)}]"
    with _lock:
        started = {label(n, d): (n, d, _start(n, d)) for n, d in jobs}
        logs = {key: _finish(n, s, d) for key, (n, d, s) in started.items()}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (under `defines`), built
    first if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            _finish(name, _start(name, key[1]))
            lib = ctypes.CDLL(_target(name, key[1]))
            _loaded[key] = lib
    return lib


_bound: dict = {}


def bind(name: str, fname: str, argtypes: list, defines: tuple = ()):
    """The C function `fname` of the library for `csrc/<name>.cu`, its
    prototype (returns int, takes `argtypes`) set once per library rather
    than on every call."""
    key = (name, tuple(defines), fname)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(load(name, defines), fname)
        fn.restype, fn.argtypes = ctypes.c_int, list(argtypes)
        _bound[key] = fn
    return fn


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise on a non-zero `cudaGetLastError()` returned by a launch."""
    if code != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_no_grad(name: str, *tensors) -> None:
    """Forward-only kernels: raise rather than return a tensor without a
    graph when a gradient is asked for."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only on a CUDA tensor: call it under torch.no_grad(), "
            "or use its plain version or the training form for gradients")

"""Timing on the card for the port's bench scripts and `chip_smoke.py`
(counterpart of `cvpr23_lfdm_tpu/utils/profiling.py::time_fn`).

PyTorch returns before the device finishes, so a call is timed between two
CUDA events on the current stream; the median over the repetitions is the
reading. The L2 cache is warm: every repetition sees the same tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def time_fn(fn, iters: int = 20, warmup: int = 3, device=None) -> dict:
    """Times `fn()`: `warmup` untimed calls, then `iters` calls, each between
    two CUDA events on the current CUDA device. Returns `median_ms`,
    `min_ms`, `max_ms`, `iters` and `clock` (`"cuda_events"`). Raises
    without a CUDA device unless `device` is the CPU: then the host clock is
    read around each call and `clock` says `"host"`, so that a script can be
    rehearsed at a tiny size; such a reading is not a device time."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("time_fn measures device time: no CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    if on_cpu:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    else:
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return {"median_ms": float(np.median(times)), "min_ms": float(min(times)),
            "max_ms": float(max(times)), "iters": iters,
            "clock": "host" if on_cpu else "cuda_events"}


def profile_rows(prof) -> list:
    """Rows of a `torch.profiler` run that have device time, largest first.
    `on_device` marks device activity (kernels, copies); the other rows are
    operators, autograd nodes and runtime calls, which repeat the time of
    what they launch."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "device_ms": dev_us / 1e3, "count": ev.count,
                         "on_device": getattr(ev, "device_type", None) == DeviceType.CUDA})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows

"""Timing on the card for the port's bench scripts and `chip_smoke.py`
(counterpart of `cvpr23_lfdm_tpu/utils/profiling.py::time_fn`).

PyTorch returns before the device finishes, so a call is timed between two
CUDA events on the current stream; the median over the repetitions is the
reading (`time_fn`: the host's work in the call included). `device_ms`
reads the device time alone from torch.profiler. The L2 cache is warm:
every repetition sees the same tensors. `KERNEL_GROUPS` / `device_groups`
are the one grouping of a profile's device kernels (each of the port's own
kernels in a group of its own) that the scripts and `chip_smoke.py` read.
`span_table` splits a profile's device time by the program's `lfdm::`
spans (`utils/tracing.py`).
"""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from cvpr23_lfdm_torch.utils.tracing import ANY_THREAD, PREFIX


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


# (group, parts of device kernel names), first match wins: the port's kernels
# (`cvpr23_lfdm_torch/csrc/`, by the kernel table's rows; the fp32 kernels of
# row 2 by their namespace-qualified names), then the library's kernels
KERNEL_GROUPS = (
    ("fused_temporal_layer", ("fused_temporal_layer_mma_kernel", "fused_temporal_layer_kernel")),
    ("fused_spatial_linear_layer", ("linear_context_mma_kernel", "linear_output_mma_kernel",
                                    "::context_kernel<", "::output_kernel<")),
    ("warp_blend", ("warp_blend_kernel",)),  # rows 3, 8 and 9 are one kernel
    ("headpacked_fwd", ("headpacked_fwd_mma_kernel", "headpacked_fwd_kernel")),
    ("headpacked_bwd", ("headpacked_bwd_mma_kernel", "headpacked_bwd_kernel",
                        "headpacked_dbias_kernel")),
    ("packed_attention", ("packed_attention_mma_kernel", "packed_attention_kernel")),
    ("groupnorm_film_silu", ("groupnorm_film_silu_kernel",)),
    ("grid_sample", ("grid_sampler",)),
    ("conv_gemm", ("xmma", "cudnn", "fft", "implicit_gemm", "region_transform", "gemm", "gemv",
                   "dgrad", "wgrad", "cutlass", "flip_filter", "nchwToNhwc", "nhwcToNchw")),
    ("adam", ("multi_tensor", "foreach", "adam")),
    ("kthvalue", ("kthvalue", "gatherKthValue")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("Memcpy", "Memset", "copy")),
)
PORT_GROUPS = tuple(g for g, _ in KERNEL_GROUPS[:7])


def group_name(kernel: str) -> str:
    """The group of a device kernel's name (`other` when none matches)."""
    return next((g for g, keys in KERNEL_GROUPS if any(k in kernel for k in keys)), "other")


def device_groups(rows, per: int = 1) -> dict:
    """Device ms and launches of a profile's device rows by group, over
    `per` (videos, steps)."""
    out = {}
    for r in rows:
        entry = out.setdefault(group_name(r["name"]), {"device_ms": 0.0, "launches": 0})
        entry["device_ms"] += r["device_ms"] / per
        entry["launches"] += r["count"] / per
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


def device_ms(fn, reps: int = 10, launches: int | None = None, by: tuple = ()):
    """Device time per call of `fn`: the kernels and copies it puts on the
    card, summed by torch.profiler over `reps` calls after one warm-up, over
    `reps`. The host's work around the launches is not in it. With
    `launches` (device activities per call), a profile that recorded another
    number of them is taken once more, then given up (None): late in a long
    process the profiler has recorded half of a run's kernels, or none.
    With `by` (parts of kernel names), returns `{"total": ms, name: ms, ...}`,
    each name's share of the same profile."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in profile_rows(prof) if r["on_device"]]
        if launches is None or sum(r["count"] for r in rows) == launches * reps:
            total = sum(r["device_ms"] for r in rows) / reps
            if not by:
                return total
            return {"total": total, **{k: sum(r["device_ms"] for r in rows if k in r["name"]) / reps
                                       for k in by}}
    return None


def span_table(prof, per: int = 1) -> dict:
    """Device ms and device launches per `lfdm::` span of a torch.profiler
    run that recorded host events, over `per` (calls, steps), with the
    spans' own count over `per` (`calls`). A device activity counts for a
    span when the runtime call that launched it (its CUDA correlation id)
    ran inside a span of that name on the span's thread, or on any thread
    for the spans of `tracing.ANY_THREAD` (`backward`: autograd launches
    from its device thread). A parent's reading includes what its children
    launched on its thread."""
    from torch.autograd import DeviceType

    runtime, spans, device = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            device.append(e)
        elif e.name().startswith(PREFIX):
            spans.setdefault(e.name().removeprefix(PREFIX), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
        elif e.name().startswith("cu"):  # a CUDA runtime or driver call
            runtime[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    table = {}
    for name, ranges in sorted(spans.items()):
        key = (lambda thread: None) if name in ANY_THREAD else (lambda thread: thread)  # noqa: E731
        by_thread = {}
        for a, b, thread in sorted(ranges):
            by_thread.setdefault(key(thread), []).append((a, b))
        ms = launches = 0
        for d in device:
            launch = runtime.get(d.correlation_id())
            if launch is None:
                continue
            inside = by_thread.get(key(launch[1]), ())
            i = bisect.bisect_right(inside, (launch[0], float("inf"))) - 1
            if i >= 0 and launch[0] < inside[i][1]:
                ms += d.duration_ns() / 1e6
                launches += 1
        table[name] = {"device_ms": ms / per, "launches": launches / per, "calls": len(ranges) / per}
    return table

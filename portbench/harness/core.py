"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration's file, `portbench/traffic/<traffic>.json` (whose
`kind` names the driver, `portbench/drivers/<kind>.py`), the limits of its
check in `portbench/limits/<workload>.json`, and a reader per per-layer
metric in `portbench/metrics/<metric>.py`. A later cell, mix or metric is
new files and entries; no file here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "cvpr23_lfdm_tpu")


class NoDevice(RuntimeError):
    """The cell's chips are not there: no result is printed."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def import_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's
    or the JAX package's (compared whole: `cvpr23_lfdm_torch` is not
    `cvpr23_lfdm_tpu`)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    """A cell of `BENCHMARK.json` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @staticmethod
    def load(workload: str, bench_path: str | None = None) -> "Cell":
        bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
        mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
        return Cell(
            name=workload, chips=int(w["chips"]),
            config=load_json(os.path.join(ROOT, cfg["file"])),
            traffic=load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
            limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)],
        )


@dataclass
class Ctx:
    """What a driver is given: the cell, the seed, the device."""

    cell: Cell
    seed: int
    device: torch.device
    # test hooks: replace the driver's sizes (`config`/`traffic` keys) and
    # plant a fault in the program
    overrides: dict = field(default_factory=dict)


@dataclass
class Run:
    """What the per-layer readers read."""

    cell: Cell
    window_s: float
    units: int
    unit_s: list
    flops_per_unit: float | None
    trace: object = None  # harness.trace.Trace of the slice profiled with host events and spans
    light: object = None  # and of the slice profiled with device activity alone
    calls: dict = field(default_factory=dict)  # kernel -> [(flops, bytes)] of the host-traced slice


def power_limit() -> float | None:
    """The card's power limit in W (`nvidia-smi`), None when it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_block(ctx: Ctx) -> dict:
    if ctx.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                "count": ctx.cell.chips, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(ctx.device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(drv, seconds: float) -> tuple[float, int, list]:
    """The window: units back to back until `seconds` have passed, every one
    finished. A closed-loop driver waits for each unit before the next is
    sent and its units are timed one by one; otherwise the host enqueues
    ahead, the window ends with one synchronise, and a CUDA event after
    each unit times them on the device's timeline. Returns the window's
    seconds, the units completed and the per-unit seconds."""
    device = drv.ctx.device
    sync(device)
    times, n = [], 0
    gc.collect()  # set-up's garbage; collections inside the window are the program's own
    start = time.perf_counter()
    deadline = start + seconds
    marks = []
    while True:
        t0 = time.perf_counter()
        drv.unit(n)
        n += 1
        if device.type == "cuda" and not drv.closed_loop:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        if drv.closed_loop:
            sync(device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if t1 >= deadline:
                break
        elif time.perf_counter() >= deadline:
            break
    sync(device)
    window = time.perf_counter() - start
    steps = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return window, n, times or steps


def traced_slice(drv, first: int):
    """Profile `drv.trace_units` more units after the window, twice: first
    with device activity alone (the busy share, launches and kernel times,
    with the least profiler work on the host; a closed-loop driver's units
    each waited for, as the window waits for them), then with host events too
    and the harness's spans and kernel-call records in place (what each
    layer launched). Returns `(light, full, calls)`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.harness.spans import Installed
    from portbench.harness.trace import PREFIX, Trace

    device = drv.ctx.device
    n = drv.trace_units
    light = Trace([], n, window_s=0.0)
    if device.type == "cuda":
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                drv.unit(first + i)
                if drv.closed_loop:
                    sync(device)
            sync(device)
            window = time.perf_counter() - t0
        light = Trace(prof.profiler.kineto_results.events(), n, window_s=window)
    inst = Installed()
    drv.install(inst)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    try:
        with profile(activities=acts) as prof:
            for i in range(n):
                with record_function(PREFIX + "unit"):
                    drv.unit(first + n + i)
                    sync(device)
    finally:
        inst.undo()
    return light, Trace(prof.profiler.kineto_results.events(), n), inst.calls


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        reader = import_file(os.path.join(HERE, "metrics", m["name"] + ".py"), "portbench_metric_" + m["name"])
        value = reader.read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """`correct` and the compared numbers beside their limits: the numbers
    the cell's limits file names (a driver may work out more), each within
    its limit and finite, and no failed unit."""
    shown, ok = {}, failed == 0
    for name, entry in limits["numbers"].items():
        value = numbers[name]
        ok &= value is not None and math.isfinite(value) and value <= entry["limit"]
        shown[name] = {"value": value, "limit": entry["limit"]}
    shown["failed"] = {"value": failed, "limit": 0}
    return ok, shown


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device=None, overrides=None, bench_path=None) -> dict:
    """One run of `workload`; returns the result line's object. `device`
    other than the card, `overrides` and `bench_path` are for the tests."""
    cell = Cell.load(workload, bench_path)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{workload} needs {cell.chips} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    ctx = Ctx(cell=cell, seed=seed, device=torch.device(device), overrides=overrides or {})
    drv = import_file(os.path.join(HERE, "drivers", cell.traffic["kind"] + ".py"),
                      "portbench_driver_" + cell.traffic["kind"]).Driver(ctx)
    setup_s = time.perf_counter() - t0
    window_s, units, unit_s = measure(drv, seconds)
    dev = device_block(ctx)
    attempted, failed = drv.after_window(units)
    if trace:
        light, tr, calls = traced_slice(drv, units)
        metrics = per_layer(Run(cell=cell, window_s=window_s, units=units, unit_s=unit_s,
                                flops_per_unit=drv.flops(), trace=tr, light=light, calls=calls))
        dev["busy_s"] = light.busy_s
        dev["window_s"] = light.window_s
        dev["power_limit_w"] = power_limit()  # the peaks behind rooflines and `mfu` assume 700 W
    else:
        e2e = drv.end_to_end(window_s, units)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    numbers = drv.check()
    correct, shown = judge(numbers, cell.limits, failed)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": light.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["window"] = {"seconds": window_s, "units": units,
                        "unit_ms_median": statistics.median(unit_s) * 1e3 if unit_s else None,
                        "unit_ms": [round(t * 1e3, 1) for t in unit_s]}
    result["compared"] = shown
    return result

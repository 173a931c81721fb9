"""What the per-layer readers of `portbench/metrics/` share: each reader
is one call of these on the traced run (`core.Run`), and returns None
where its run has nothing to read."""

from __future__ import annotations

import statistics

from portbench.harness.counts import PEAK_FLOPS, bound_s


def percentile_ms(run, q: int) -> float | None:
    """The q-th percentile of the window's units, host clock, in ms."""
    if len(run.unit_s) < 2:
        return None
    return statistics.quantiles(run.unit_s, n=100, method="inclusive")[q - 1] * 1e3


def span_ms(run, *parts: str) -> float | None:
    """Device ms per unit launched inside the named spans."""
    tr = run.trace
    vals = [tr.span_us(p) for p in parts]
    if any(v is None for v in vals):
        return None
    return sum(vals) / 1e3


def step_rest_ms(run, *parts: str) -> float | None:
    """Device ms per unit outside the named spans."""
    tr = run.trace
    spans = [tr.span_us(p) for p in parts]
    if not tr.device or any(v is None for v in spans):
        return None
    return (tr.total_us() - sum(spans)) / 1e3


def group_ms(run, *groups: str) -> float | None:
    us = run.trace.group_us(*groups)
    return None if not us else us / 1e3


def idle_pct(run) -> float | None:
    """The share of the slice profiled with device activity alone in which
    nothing ran on the device."""
    tr = run.light
    if not tr.device or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0


def launches(run) -> float | None:
    tr = run.light
    return tr.launches / tr.units if tr.device else None


def mfu_pct(run, dtype: str) -> float | None:
    """The whole unit's product FLOPs (counted over the reference) over the
    window's time per unit, as a share of the card's peak in `dtype`."""
    if not run.flops_per_unit or not run.units or not run.light.device:
        return None
    return run.flops_per_unit / (run.window_s / run.units) / PEAK_FLOPS[dtype] * 100.0


def roofline_pct(run, kernels: tuple, groups: tuple, dtype: str) -> float | None:
    """The kernels' least time (each call's bound from its shapes) over
    their device time in the traced slice, as a share."""
    calls = [c for k in kernels for c in run.calls.get(k, [])]
    us = run.trace.group_us(*groups)
    if not calls or not us:
        return None
    device_s = us * run.trace.units / 1e6
    return sum(bound_s(f, b, dtype) for f, b in calls) / device_s * 100.0

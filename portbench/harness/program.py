"""Reading the program's own spans from the slice traced with host events.

The port opens a host range `lfdm::<name>` at each layer boundary of its
serving call and its DM step (`cvpr23_lfdm_torch/utils/tracing.py`) while
a profiler session runs, so they are in the slice that `core.traced_slice`
profiles with host events (`run.trace`), beside the harness's own
`portbench::` spans. They are function-scope ranges, which kineto puts on
the host timeline only. This file imports nothing of the program's: a
slice without such a span (a program that does not open it) reads None.

A device activity is a span's when its launch ran inside a span of that
name on the span's thread. `backward` is the exception: autograd launches
the backward's kernels from its own device thread while the calling thread
waits inside the span, so there a launch on any thread inside the span's
interval counts.
"""

from __future__ import annotations

import bisect
import math

PREFIX = "lfdm::"
ANY_THREAD = ("backward",)
NO_SPAN = "no span"


def _spans(tr, name: str) -> list:
    return [e for e in tr.host if e.name == PREFIX + name]


def launched(tr, name: str) -> list | None:
    """The device activities launched inside the spans `name`; None when
    the slice has no such span or no device activity."""
    spans = _spans(tr, name)
    if not spans or not tr.device:
        return None
    key = (lambda thread: None) if name in ANY_THREAD else (lambda thread: thread)  # noqa: E731
    ranges = {}
    for s in sorted(spans, key=lambda s: s.start):
        ranges.setdefault(key(s.thread), []).append((s.start, s.end))
    out = []
    for d in tr.device:
        if d.launch is None:
            continue
        t, thread = d.launch
        inside = ranges.get(key(thread), [])
        i = bisect.bisect_right(inside, (t, math.inf)) - 1
        if i >= 0 and t < inside[i][1]:
            out.append(d)
    return out


def span_ms(run, name: str) -> float | None:
    """Device ms per unit launched inside the spans `name`."""
    acts = launched(run.trace, name)
    return None if acts is None else sum(d.end - d.start for d in acts) / 1e6 / run.trace.units


def span_launches(run, name: str) -> float | None:
    """Device activities (kernels, copies, sets) per unit launched inside
    the spans `name`."""
    acts = launched(run.trace, name)
    return None if acts is None else len(acts) / run.trace.units


def gaps(tr) -> list:
    """`[(start ns, ns, [names of the spans the host was in]), ...]`: the
    device's idle stretches inside the slice's window, each with the
    program spans that held its start, outermost first."""
    spans = sorted((e for e in tr.host if e.name.startswith(PREFIX)), key=lambda e: (e.start, -e.end))
    out, prev = [], tr.start
    for a, b in tr._merged() + [[tr.end, tr.end]]:
        if a > prev:
            out.append((prev, a - prev, [s.name.removeprefix(PREFIX) for s in spans if s.start <= prev < s.end]))
        prev = max(prev, b)
    return out


def gap_ms(run, name: str) -> float | None:
    """Device idle ms per unit in the gaps that began while the host was
    inside the spans `name`; None when the slice has no such span."""
    tr = run.trace
    if not _spans(tr, name) or not tr.device:
        return None
    return sum(n for _, n, inside in gaps(tr) if name in inside) / 1e6 / tr.units


def idle_by_span(tr) -> dict:
    """`{span: seconds per unit}`: the slice's idle by the innermost program
    span the host was in when each gap began (`NO_SPAN` outside them)."""
    out = {}
    for _, n, inside in gaps(tr):
        name = inside[-1] if inside else NO_SPAN
        out[name] = out.get(name, 0.0) + n / 1e9 / tr.units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))

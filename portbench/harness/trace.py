"""Reading a `torch.profiler` run of the traced units from its raw events.

The harness's spans are `torch.profiler.record_function` ranges named
`portbench::<part>`, opened by the wrappers of `harness/spans.py` around
the calls into each layer. Every device activity (kernel, copy, set) is
tied to the host call that launched it by the CUDA correlation id it
shares with that runtime call; it belongs to a span when its launch was
made inside the span, on the span's thread. That holds for the port's own
kernels too, which are launched through `ctypes` and not from an operator
the profiler records.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from torch.autograd import DeviceType

from portbench.harness.groups import group_name

PREFIX = "portbench::"


@dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    thread: int = 0
    seq: int = -1
    launch: tuple | None = None  # (host ns, thread) of a device activity's launch


def _events(kineto_events):
    """`(host, device)`: the host events and the device activities, each
    device activity with its launch found by correlation id."""
    host, device, runtime = [], [], {}
    for e in kineto_events:
        start = e.start_ns()
        ev = Event(e.name(), start, start + e.duration_ns(), e.start_thread_id(), e.sequence_nr())
        if e.device_type() == DeviceType.CPU:
            host.append(ev)
            if ev.name.startswith("cu"):  # a CUDA runtime or driver call
                runtime[e.correlation_id()] = (start, ev.thread)
        elif not ev.name.startswith(PREFIX):  # not the device copy of a span
            ev.seq = e.correlation_id()
            device.append(ev)
    for d in device:
        d.launch = runtime.get(d.seq)
    device.sort(key=lambda d: d.start)
    return host, device


class Trace:
    """The device activity and the spans of one profiled slice of `units`
    units (calls or steps). The window is the `portbench::unit` spans' host
    interval, or `window_s` when the slice recorded no host events."""

    def __init__(self, kineto_events, units: int, window_s: float | None = None):
        self.units = units
        self.host, self.device = _events(kineto_events)
        self.spans = [e for e in self.host if e.name.startswith(PREFIX)]
        unit = [s for s in self.spans if s.name == PREFIX + "unit"]
        if unit:
            self.start, self.end = min(s.start for s in unit), max(s.end for s in unit)
        elif self.device:
            self.start, self.end = self.device[0].start, max(d.end for d in self.device)
        else:
            self.start = self.end = 0
        self._window_s = window_s

    @property
    def window_s(self) -> float:
        return self._window_s if self._window_s is not None else (self.end - self.start) / 1e9

    def _merged(self):
        merged = []
        for d in self.device:
            a, b = max(d.start, self.start), min(d.end, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e9

    @property
    def launches(self) -> int:
        return len(self.device)

    def _launched_in(self, ranges) -> float:
        """Device microseconds per unit launched inside the host `ranges`
        (events: interval and thread)."""
        by_thread = {}
        for r in sorted(ranges, key=lambda r: r.start):
            merged = by_thread.setdefault(r.thread, [])
            if merged and r.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], r.end)
            else:
                merged.append([r.start, r.end])
        starts = {t: [a for a, _ in m] for t, m in by_thread.items()}
        total = 0
        for d in self.device:
            if d.launch is None or d.launch[1] not in by_thread:
                continue
            t, thread = d.launch
            i = bisect.bisect_right(starts[thread], t) - 1
            if i >= 0 and t < by_thread[thread][i][1]:
                total += d.end - d.start
        return total / 1e3 / self.units

    def span_us(self, part: str) -> float | None:
        """Device microseconds per unit launched inside the spans named
        `part`; None when the slice has no such span or no device activity."""
        spans = [s for s in self.spans if s.name == PREFIX + part]
        if not spans or not self.device:
            return None
        return self._launched_in(spans)

    def total_us(self) -> float:
        """Device microseconds per unit, all activity."""
        return sum(d.end - d.start for d in self.device) / 1e3 / self.units

    def group_us(self, *groups: str) -> float | None:
        """Device microseconds per unit of the activities in the named groups."""
        if not self.device:
            return None
        return sum(d.end - d.start for d in self.device if group_name(d.name) in groups) / 1e3 / self.units

    def device_ops(self, top: int = 10) -> list:
        """`[[group, seconds], ...]`, the groups with the most device time."""
        by = {}
        for d in self.device:
            g = group_name(d.name)
            by[g] = by.get(g, 0.0) + (d.end - d.start) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """`[[span, seconds], ...]`: the device's idle time inside the window
        by the innermost harness span the host was in when the gap began."""
        gaps, prev = [], self.start
        for a, b in self._merged():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.end > prev:
            gaps.append((prev, self.end))
        by = {}
        for a, b in gaps:
            inner = [s for s in self.spans if s.start <= a < s.end]
            name = min(inner, key=lambda s: s.end - s.start).name if inner else PREFIX + "host"
            name = name.removeprefix(PREFIX)
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

"""Reduction of a ``torch.profiler`` trace to what the readers and the result
line need: the device operations in a window, the seconds the device was
busy (the union of their intervals), the operations that took most time, and
the idle gaps by what the host was doing.

The window is bounded by the benchmark's own spans (``record_function``),
which the profiler records on the host's side of the same clock. Device
operations are the events the profiler places on the card: kernels, also
those inside CUDA-graph replays, copies and sets. A span's annotation, which
newer profilers mirror onto the card's timeline, is not an operation.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple

# the benchmark's spans; names under this prefix are never device work
SPAN = "bench."
TOP = 10
# characters of an operation's name kept in the breakdown
NAME_CHARS = 160


class Event(NamedTuple):
    name: str
    start: float          # seconds on the profiler's clock
    end: float


def _seconds(e):
    if hasattr(e, "start_ns"):
        s = e.start_ns() / 1e9
        return s, s + e.duration_ns() / 1e9
    s = e.start_us() / 1e6
    return s, s + e.duration_us() / 1e6


def split_events(prof):
    """(device events, host events) of a finished profile, each sorted by
    start."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = _seconds(e)
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            host.append(Event(name, s, t))
        elif not name.startswith(SPAN) and not (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            device.append(Event(name, s, t))
    device.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return device, host


def span_window(host: List[Event], name: str):
    """(start, end) from the first span `name` to the end of the last."""
    spans = [e for e in host if e.name == name]
    if not spans:
        return None
    return spans[0].start, max(e.end for e in spans)


def is_kernel(e: Event) -> bool:
    return not e.name.startswith(("Memcpy", "Memset"))


class Window:
    """The device's work inside one window [start, end]."""

    def __init__(self, device: List[Event], host: List[Event], start: float,
                 end: float):
        self.start, self.end = start, end
        self.ops = [e for e in device if e.end > start and e.start < end]
        self.host = host
        merged = []
        for e in self.ops:
            s, t = max(e.start, start), min(e.end, end)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.merged = merged

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.merged)

    def kernels(self) -> List[Event]:
        return [e for e in self.ops if is_kernel(e)]

    def idle_share(self):
        if not self.ops or self.seconds <= 0:
            return None
        return 1.0 - self.busy_s / self.seconds

    def top_ops(self, n: int = TOP):
        by = defaultdict(float)
        for e in self.ops:
            by[e.name[:NAME_CHARS]] += e.end - e.start
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = TOP, examined: int = 2000,
                  lookback: int = 256):
        """The idle gaps' seconds summed by the innermost host event that
        covers each gap's middle (the `examined` longest gaps; the covering
        event is sought among the `lookback` host events that began last
        before the middle)."""
        edges = [self.start] + [x for iv in self.merged for x in iv] + \
            [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:examined]
        host = [e for e in self.host if e.end > self.start
                and e.start < self.end]
        spans = [e for e in host if e.name.startswith(SPAN)]
        starts = [e.start for e in host]
        by = defaultdict(float)
        for length, s in gaps:
            mid = s + length / 2
            hi = bisect.bisect_right(starts, mid)
            best = None
            for e in host[max(0, hi - lookback):hi] + spans:
                if e.start <= mid <= e.end and (best is None or
                                     e.end - e.start < best.end - best.start):
                    best = e
            by[best.name if best else "no host event"] += length
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

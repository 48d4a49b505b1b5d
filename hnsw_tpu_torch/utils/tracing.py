"""The port's one tracer: host spans, and device marks and counters.

Host spans are always on. ``span(name, **attrs)`` is a context manager that
records the span's name, start, end, its own id, its parent's (the span it
opened inside, 0 for a root) and its request's (the root's id) into a ring
of ``RING`` entries that overwrites its oldest entry once full and never
grows. Per-name totals (count, nanoseconds) beside the ring count every span,
also those the ring has dropped. While a ``torch.profiler`` records, a span
is mirrored as a ``record_function`` of the same name, so it shows in the
profiler's trace (and ``profiling.profile_trace``'s Chrome trace).

Clock. Spans are recorded on ``time.perf_counter_ns`` (monotonic) and
exported on the profiler's clock, Unix-epoch nanoseconds: a span's exported
times are its monotonic times plus the offset between ``time.time_ns`` and
``time.perf_counter_ns`` read when the tracer was made. So every idle gap of
a device trace can be put down to the innermost span the host was in.

Device tracing is off unless ``enable_device(True)`` switches it on, and
only then do ``mark`` and ``count`` record anything; off, they launch
nothing. ``mark(phase, device)`` closes the phase open on that device and
opens ``phase``; the first phase of ``PHASES``, ``entry``, opens a run and
closes nothing, and ``mark(END, device)`` closes the run. On a CUDA device a
mark is a one-thread kernel (``stamp``, ``csrc/trace.cu``) that reads the
card's ``%globaltimer`` and adds the nanoseconds since the last mark to the
closed phase, in a buffer the tracer owns on the card, so marks recorded in
a CUDA graph add up over every replay with no host sync. (Timing events
recorded in a graph are overwritten by each replay, and reading them needs a
wait on the card after every replay.) On the CPU a mark reads the host
clock: the CPU search runs synchronously. ``count(name, value)`` adds a
device scalar (or an int) into an int64 counter the tracer owns on the
value's device. ``collect()`` is the only call that waits on the card: it
returns the spans, the phases' milliseconds and the runs, and the counters
recorded since the last collect, and starts them afresh.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch

RING = 1 << 16
# the phases of a search, in the order a run opens them; "dequant" opens
# only on the int8 pack's route; "count" holds the counters' kernels, so
# that the others read clean
PHASES = ("entry", "select", "expand", "score", "dequant", "merge", "rerank",
          "count")
END = "end"
# counters a device holds
COUNTERS = 32
# stamp buffer of a device: [last mark's ns, runs, ns of each phase]
_LAST, _RUNS, _PHASE0 = 0, 1, 2
_PHASE = {p: i for i, p in enumerate(PHASES)}

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int         # on the profiler's clock (Unix-epoch ns)
    end_ns: int
    id: int
    parent: int           # 0 for a root
    request: int          # the root's id
    attrs: dict


class Trace(NamedTuple):
    """What collect() returns: spans oldest first, the runs (first marks)
    seen, each phase's milliseconds summed over them, and the counters."""
    spans: List[Span]
    runs: int
    phase_ms: Dict[str, float]
    counters: Dict[str, int]


def _clock_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def stamp(state: torch.Tensor, close: int) -> None:
    """Launch the one-thread kernel of csrc/trace.cu on the current stream:
    it adds %globaltimer's ns since state[0] to state[2 + close] (close >= 0)
    or counts a run in state[1] (close < 0), and stores the time in
    state[0]. state: int64 on a CUDA device."""
    from hnsw_tpu_torch.ops import _cuda

    code = _cuda.library("trace.cu").trace_stamp(
        state.data_ptr(), close, _cuda.stream_ptr(state.device))
    _cuda.check(code, "trace_stamp")
    stamp.launches += 1


stamp.launches = 0


class _Thread(threading.local):
    """A thread's open spans and its per-name totals (so that recording
    takes no lock), registered with its tracer once per thread."""

    def __init__(self, tracer):
        self.spans = []
        self.totals = {}
        with tracer._lock:
            tracer._thread_totals.append(self.totals)


class _Device:
    """What the tracer holds on one device: the stamp buffer (a list of ints
    on the CPU), the counters, and the phase open there (-1: none)."""

    def __init__(self, device: torch.device):
        self.device = device
        width = _PHASE0 + len(PHASES)
        self.stamps = (torch.zeros(width, dtype=torch.int64, device=device)
                       if device.type == "cuda" else [0] * width)
        self.counts = torch.zeros(COUNTERS, dtype=torch.int64, device=device)
        self.open = -1


class _Open:
    """A span being recorded."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "request",
                 "t0", "local", "mirror")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        self.local = local = tr._local
        self.id = sid = next(tr._ids)
        stack = local.spans
        if stack:
            self.parent, self.request = stack[-1].id, stack[0].id
        else:
            self.parent, self.request = 0, sid
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if _profiling():
            # the mirror's event starts in its __enter__, which can take a
            # millisecond the first time: the span starts before it
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        else:
            self.mirror = None
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        local, t0, tr = self.local, self.t0, self.tracer
        local.spans.pop()
        # one atomic step takes the slot, one fills it; the slot's index
        # goes with the record, so that collect tells a filled slot from
        # one left over from the ring's previous lap
        i = next(tr._seq)
        tr._ring[i & tr._mask] = (i, self.name, t0, t1, self.id,
                                  self.parent, self.request, self.attrs)
        total = local.totals.get(self.name)
        if total is None:
            local.totals[self.name] = [1, t1 - t0]
        else:
            total[0] += 1
            total[1] += t1 - t0
        return False


class Tracer:
    """Host spans in a ring of `ring` entries (a power of two), and the
    device marks and counters. The port records into TRACER."""

    def __init__(self, ring: int = RING):
        if ring <= 0 or ring & (ring - 1):
            raise ValueError(f"ring of {ring} entries: not a power of two")
        self._ring: list = [None] * ring
        self._mask = ring - 1
        self._seq = itertools.count()  # a span's slot index, in order
        self._drained = 0            # slot indices below it are collected
        self.dropped = 0             # spans overwritten or unfinished when
                                     # collected
        self._ids = itertools.count(1)
        self._lock = threading.Lock()  # registration and collect
        self._thread_totals: List[dict] = []
        self._local = _Thread(self)
        self.offset_ns = _clock_offset_ns()
        self._device_on = False
        self._devices: Dict[torch.device, _Device] = {}
        self._counter_ix: Dict[str, int] = {}

    # ---- host spans ------------------------------------------------------
    def span(self, name: str, **attrs) -> _Open:
        return _Open(self, name, attrs)

    def totals(self) -> Dict[str, Dict[str, int]]:
        """{name: {"count", "ns"}} over every span recorded, those the ring
        dropped included."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            per_thread = [t.copy() for t in self._thread_totals]
        for totals in per_thread:
            for name, (c, ns) in totals.items():
                o = out.setdefault(name, {"count": 0, "ns": 0})
                o["count"] += c
                o["ns"] += ns
        return out

    def to_profiler_ns(self, monotonic_ns: int) -> int:
        """A time.perf_counter_ns() reading on the profiler's clock."""
        return monotonic_ns + self.offset_ns

    # ---- device marks and counters --------------------------------------
    def device_tracing(self) -> bool:
        return self._device_on

    def enable_device(self, on: bool) -> None:
        self._device_on = bool(on)
        for d in self._devices.values():
            d.open = -1

    def _dev(self, device) -> _Device:
        d = self._devices.get(device)
        if d is None:
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            d = self._devices.get(dev) or _Device(dev)
            self._devices[dev] = self._devices[device] = d
        return d

    def mark(self, phase: str, device) -> None:
        """Close the phase open on `device` and open `phase` (END: none);
        a phase marked while open goes on."""
        if not self._device_on:
            return
        d = self._dev(device)
        opens = -1 if phase == END else _PHASE[phase]
        if opens == d.open >= 0:
            return
        close = -1 if opens == 0 else d.open
        d.open = opens
        if d.device.type == "cuda":
            stamp(d.stamps, close)
            return
        t = time.perf_counter_ns()
        st = d.stamps
        if close >= 0:
            st[_PHASE0 + close] += t - st[_LAST]
        else:
            st[_RUNS] += 1
        st[_LAST] = t

    def count(self, name: str, value, device=None) -> None:
        """Add `value` (a device scalar, or an int on `device`) into the
        counter `name`, with no sync."""
        if not self._device_on:
            return
        i = self._counter_ix.get(name)
        if i is None:
            with self._lock:
                if len(self._counter_ix) >= COUNTERS:
                    raise ValueError(f"more than {COUNTERS} counters")
                i = self._counter_ix.setdefault(name, len(self._counter_ix))
        if device is None:
            device = value.device
        self._dev(device).counts.narrow(0, i, 1).add_(value)

    # ---- collect ---------------------------------------------------------
    def collect(self) -> Trace:
        """Everything recorded since the last collect, then start afresh:
        the spans the ring still holds (oldest first, on the profiler's
        clock), the runs and each phase's ms summed over the devices, and
        the counters. Waits on a card only where device tracing recorded
        there."""
        with self._lock:
            # slot n stays empty: no span takes it, and the slot it shares
            # with n - len(ring) keeps that span
            n = next(self._seq)
            first = max(self._drained, n - len(self._ring))
            raw = [self._ring[i & self._mask] for i in range(first, n)]
            raw = [r for i, r in zip(range(first, n), raw)
                   if r is not None and r[0] == i]
            self.dropped += n - self._drained - len(raw)
            self._drained = n + 1
        off = self.offset_ns
        spans = [Span(name, t0 + off, t1 + off, sid, parent, req, attrs)
                 for _, name, t0, t1, sid, parent, req, attrs in raw]
        runs, phase_ns = 0, [0] * len(PHASES)
        counts = [0] * COUNTERS
        for d in {id(d): d for d in self._devices.values()}.values():
            if d.device.type == "cuda":
                torch.cuda.synchronize(d.device)
                st = d.stamps.tolist()
                d.stamps.zero_()
            else:
                st, d.stamps = d.stamps, [0] * len(d.stamps)
            runs += st[_RUNS]
            phase_ns = [a + b for a, b in zip(phase_ns, st[_PHASE0:])]
            counts = [a + b for a, b in zip(counts, d.counts.tolist())]
            d.counts.zero_()
        return Trace(spans, runs,
                     {p: ns / 1e6 for p, ns in zip(PHASES, phase_ns)},
                     {name: counts[i] for name, i in self._counter_ix.items()})


TRACER = Tracer()
span = TRACER.span
mark = TRACER.mark
count = TRACER.count
collect = TRACER.collect
device_tracing = TRACER.device_tracing
enable_device = TRACER.enable_device
totals = TRACER.totals
to_profiler_ns = TRACER.to_profiler_ns

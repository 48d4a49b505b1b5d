"""What the program's own tracer (``hnsw_tpu_torch/utils/tracing.py``) holds
after a traced run's window, read once a run for every reader of a
``program_span`` or ``program_counter`` metric and kept on the readers'
context.

- Host spans, which the program records always: those of the window's
  requests that ran before the profiler started (``hnsw.search`` roots that
  began before the first traced request, and their ``pad`` and ``replay``
  children), and those of the set-up's timed builds (the last ``BUILDS``
  ``hnsw.build`` roots of the corpus's rows before the window, and their
  ``layers``, ``fetch`` and ``repair`` children).
- Device marks and counters, which the program records only with device
  tracing on: switched on here, the client's first traced batch runs once
  through ``HNSWIndex.search_batch`` (a new capture, whose graph holds the
  marks; then collected to forget its eager run) and then ``BATCHES``
  batches from there replay it; their phases and counters are collected,
  and device tracing goes off again, also on a failure.

A program without the tracer gives None, and so does each reader.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from benchmark.cell import BUILDS

BATCHES = 16
SIX = ("entry", "select", "expand", "score", "merge", "rerank")


class ProgramTrace(NamedTuple):
    requests: List[Dict[str, float]]   # per untraced request: child -> s
    builds: List[Dict[str, float]]     # per timed build: child -> s
    batches: int                       # runs the marks counted
    phase_ms: Dict[str, float]         # summed over the batches
    counters: Dict[str, int]           # summed over the batches
    batch: int                         # queries a batch

    def per_batch_ms(self, phase: str) -> Optional[float]:
        if not self.batches or phase not in self.phase_ms:
            return None
        return self.phase_ms[phase] / self.batches

    def mean(self, which: str, child: str) -> Optional[float]:
        """Mean seconds of the child span `child` over the requests or
        builds that have one."""
        got = [r[child] for r in getattr(self, which) if child in r]
        return sum(got) / len(got) if got else None


def get(ctx) -> Optional[ProgramTrace]:
    """The run's ProgramTrace, read at the first call (None where the
    program has no tracer)."""
    if "program_trace" not in ctx.__dict__:
        ctx.program_trace = _read(ctx)
    return ctx.program_trace


def _children(spans, roots) -> List[Dict[str, float]]:
    """{child's last name part: seconds} of each root, in the roots' order."""
    by = defaultdict(dict)
    for s in spans:
        if s.parent and s.request in roots:
            by[s.request][s.name.rsplit(".", 1)[-1]] = \
                (s.end_ns - s.start_ns) / 1e9
    return [by[r] for r in roots]


def _read(ctx) -> Optional[ProgramTrace]:
    try:
        from hnsw_tpu_torch.utils import tracing
    except ImportError:
        return None
    held = tracing.collect().spans
    reqs = ctx.requests
    if not reqs:
        return None

    def on_profiler_clock(t: float) -> int:
        return tracing.to_profiler_ns(round(t * 1e9))

    lo = on_profiler_clock(reqs[0].t0)
    hi = (on_profiler_clock(reqs[ctx.first_traced].t0)
          if ctx.first_traced < len(reqs) else float("inf"))
    requests = [s.id for s in held if s.name == "hnsw.search"
                and lo <= s.start_ns < hi]
    builds = [s.id for s in held if s.name == "hnsw.build"
              and s.attrs.get("rows") == ctx.index.corpus.n
              and s.end_ns <= lo][-BUILDS:]

    def search(i):
        ctx.index.search_batch(ctx.client.queries(i), ctx.k, ctx.mode,
                               ef=ctx.ef)

    tracing.enable_device(True)
    try:
        search(ctx.first_traced)
        tracing.collect()
        for i in range(BATCHES):
            search(ctx.first_traced + i)
        device = tracing.collect()
    finally:
        tracing.enable_device(False)
    return ProgramTrace(_children(held, requests), _children(held, builds),
                        device.runs, device.phase_ms, device.counters,
                        ctx.client.batch)

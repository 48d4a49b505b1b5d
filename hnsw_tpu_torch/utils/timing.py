"""Timing spans on the host clock (copy of ``hnsw_tpu/utils/timing.py``).
CUDA work returns before it ends: synchronize inside a span that times it."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class Timer:
    """Accumulates named spans; reports totals and counts."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": sum(v), "count": len(v),
                   "avg_ms": 1e3 * sum(v) / len(v)}
            for name, v in self.spans.items()
        }


@contextlib.contextmanager
def timed(label: str, out: Optional[list] = None, verbose: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if out is not None:
        out.append((label, dt))
    if verbose:
        print(f"[{label}] {dt * 1e3:.2f} ms")

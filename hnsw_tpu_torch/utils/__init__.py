"""Utilities: the port's one tracer (host spans, device marks and counters)
and the profiler's Chrome trace. Counterpart of ``hnsw_tpu/utils/``: its
``Timer`` and ``timed`` (``timing.py``) and ``annotate`` have no twin, as
``tracing.span`` records and mirrors into the profiler what they did, and its
compile-cache scrub, ``cache.py``, has none: the port's only build cache is
the kernel libraries of ``_build/``, keyed by source digest and written
atomically."""

from hnsw_tpu_torch.utils import tracing

__all__ = ["tracing"]

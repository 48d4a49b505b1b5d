"""Utilities: timing spans and profiler hooks. Counterpart of
``hnsw_tpu/utils/`` (its compile-cache scrub, ``cache.py``, has no twin:
the port's only build cache is the kernel libraries of ``_build/``, keyed
by source digest and written atomically)."""

from hnsw_tpu_torch.utils.timing import Timer, timed

__all__ = ["Timer", "timed"]

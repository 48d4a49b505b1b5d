"""The profiler's Chrome trace on ``torch.profiler``. Counterpart of
``hnsw_tpu/utils/profiling.py`` (``jax.profiler``). Its ``annotate`` has no
twin: the port's spans (``utils/tracing.py``) show in the trace as
``record_function`` ranges of their names while a profiler records."""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Trace the host and, where there is one, the CUDA device around a
    block, and write the Chrome trace to <log_dir>/trace.json (default
    log_dir: hnsw_tpu_torch_trace under the temporary directory). Yields
    log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "hnsw_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


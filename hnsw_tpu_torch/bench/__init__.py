"""Benchmark harness: QPS, latency percentiles, recall against the exact
flat index, build time. Counterpart of ``hnsw_tpu/bench/``."""

from hnsw_tpu_torch.bench.harness import (
    build_with_timeout,
    latency_report,
    measure_build,
    run_recall_benchmark,
    run_search_benchmark,
    warmup,
)

__all__ = [
    "build_with_timeout",
    "latency_report",
    "measure_build",
    "run_recall_benchmark",
    "run_search_benchmark",
    "warmup",
]

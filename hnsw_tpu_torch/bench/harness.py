"""Measurement core. Counterpart of ``hnsw_tpu/bench/harness.py``, with the
same return keys.

The reference's benchmark methodology (bench.clj): build time, latency
percentile tables (min/p50/p95/p99/max/avg from sorted samples), exact-kNN
ground truth by brute force and recall = |approx ∩ exact| / k averaged over
queries drawn from the corpus itself. QPS is batched throughput.

On the card: queries are staged on the device once; ``qps_batched`` is a
loop of searches dispatched back to back and closed by one
``torch.cuda.synchronize()``, and ``qps_device`` the two-point slope of
that loop (the time per batch once the fixed cost of the loop is taken
out). A search that raises makes the benchmark raise: the reference drops
that error and reports no device QPS (ROADMAP §C).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import Mode


def _sync(x) -> None:
    """Wait for the device that x (a tensor, or an index's corpus) is on."""
    corpus = getattr(x, "corpus", None)
    if corpus is not None:
        x = corpus.vectors
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def measure_build(build_fn: Callable[[], Any]) -> tuple:
    """Returns (index, seconds) on the host clock, the device synced."""
    t0 = time.perf_counter()
    idx = build_fn()
    _sync(idx)
    return idx, time.perf_counter() - t0


def latency_report(samples_ms) -> Dict[str, float]:
    """min/p50/p95/p99/max/avg table (bench.clj:109-122)."""
    s = np.sort(np.asarray(samples_ms, np.float64))
    if len(s) == 0:
        return {}

    def pct(p):
        return float(s[min(int(len(s) * p), len(s) - 1)])
    return {
        "min_ms": float(s[0]),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "max_ms": float(s[-1]),
        "avg_ms": float(s.mean()),
    }


def run_search_benchmark(
    index,
    queries: np.ndarray,
    *,
    k: int = 10,
    mode: Mode = Mode.BALANCED,
    batch_size: int = 256,
    warmup: int = 3,
    iters: int = 10,
    single_query_iters: int = 30,
) -> Dict[str, Any]:
    """Batched-throughput QPS, its device slope, and single-query latency
    percentiles (single_query_iters=0 skips those)."""
    queries = np.asarray(queries, np.float32)
    b = min(batch_size, len(queries))
    batch = index.corpus.pad_queries(queries[:b])   # staged on device once
    search = index.search_batch

    for _ in range(warmup):
        d, _ = search(batch, k, mode)
    _sync(d)

    def pipelined(m: int) -> float:
        # m searches dispatched back to back, one synchronize at the end
        t0 = time.perf_counter()
        for _ in range(m):
            d, _ = search(batch, k, mode)
        _sync(d)
        return time.perf_counter() - t0

    dt = pipelined(iters) / iters
    qps = b / dt

    lat = []
    if single_query_iters > 0:
        one = batch[:1]
        for _ in range(3):
            d, _ = search(one, k, mode)
        _sync(d)
        for _ in range(single_query_iters):
            t0 = time.perf_counter()
            d, _ = search(one, k, mode)
            _sync(d)
            lat.append((time.perf_counter() - t0) * 1e3)

    # two-point slope: grow the loop length geometrically until it takes
    # 0.35 s, then difference the last two points; the amortized time of the
    # longer loop bounds the slope from above and floors it
    n_lo, t_lo = 4, pipelined(4)
    n_hi, t_hi = n_lo, t_lo
    while t_hi < 0.35 and n_hi < 4096:
        n_lo, t_lo = n_hi, t_hi
        n_hi *= 4
        t_hi = pipelined(n_hi)
    if n_hi == n_lo:                      # the first point is already slow
        n_hi = 2 * n_lo
        t_hi = pipelined(n_hi)
    per_batch = (t_hi - t_lo) / (n_hi - n_lo)
    if per_batch <= 0 or per_batch < 0.25 * (t_hi / n_hi):
        per_batch = t_hi / n_hi
    qps_device = b / per_batch

    rep = latency_report(lat)
    rep["qps_device"] = float(qps_device)
    rep["per_query_us_device"] = 1e6 / qps_device
    rep.update({
        "qps_batched": float(qps),
        "batch_size": b,
        "batch_latency_ms": dt * 1e3,
        "per_query_ms_batched": dt * 1e3 / b,
        "qps_single": 1e3 / rep["avg_ms"] if rep.get("avg_ms") else 0.0,
        "k": k,
        "mode": str(Mode.coerce(mode).value),
    })
    return rep


def run_recall_benchmark(
    index,
    data: np.ndarray,
    *,
    k: int = 10,
    mode: Mode = Mode.BALANCED,
    num_queries: int = 100,
    exact_index=None,
    seed: int = 42,
) -> Dict[str, float]:
    """Recall@k against the exact f32 flat index (bench.clj:286-310):
    queries drawn from the corpus itself."""
    from hnsw_tpu_torch.models.flat import FlatIndex

    rng = np.random.default_rng(seed)
    n = len(data)
    qidx = rng.choice(n, size=min(num_queries, n), replace=False)
    queries = np.asarray(data, np.float32)[qidx]

    if exact_index is None:
        exact_index = FlatIndex(index.corpus)
    _, exact_rows = exact_index.search_batch(queries, k)
    _, approx_rows = index.search_batch(queries, k, mode)
    exact_rows = exact_rows.cpu().numpy()
    approx_rows = approx_rows.cpu().numpy()

    recalls = []
    for a, e in zip(approx_rows, exact_rows):
        ea = set(int(x) for x in e if int(x) >= 0)
        aa = set(int(x) for x in a if int(x) >= 0)
        recalls.append(len(aa & ea) / max(len(ea), 1))
    return {
        "recall_at_k": float(np.mean(recalls)),
        "k": k,
        "num_queries": len(queries),
        "mode": str(Mode.coerce(mode).value),
    }


def warmup(index, dim: Optional[int] = None, rounds: int = 2):
    """Run representative searches (one query, and a batch of up to 256) so
    that later calls find their kernels built and their caches filled."""
    d = dim or index.corpus.dim
    k = min(10, max(index.corpus.n, 1))
    q = np.zeros((1, d), np.float32)
    qb = np.zeros((min(256, max(index.corpus.n, 1)), d), np.float32)
    for _ in range(rounds):
        index.search_batch(q, k)
        index.search_batch(qb, k)
    return index


def build_with_timeout(build_fn, timeout_s: float, fallback_fn=None):
    """Run a build with a wall-clock budget; on timeout (or a failed build)
    build the fallback instead. Without a fallback, a timeout raises
    TimeoutError and a failed build re-raises its error. Returns (index,
    used_fallback)."""
    result = {}

    def run():
        try:
            result["idx"] = build_fn()
        except Exception as e:  # surfaced to the caller below
            result["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive() or "err" in result:
        if fallback_fn is None:
            if "err" in result:
                raise result["err"]
            raise TimeoutError(f"build exceeded {timeout_s}s and no fallback")
        return fallback_fn(), True
    return result["idx"], False

"""Benchmark CLI — the reference's bench.clj command surface. Counterpart of
``hnsw_tpu/bench/cli.py``.

Modes (bench.clj:1008-1044): quick (1k subset), full (whole corpus,
fast-building families), demo <method> <size>, multiprobe (LSH sweep),
pcaf (PCAF mode sweep), multithread (batch-size scaling, the analogue of
the reference's thread-count scaling test, parallel_search.clj:97-147).

Usage: python -m hnsw_tpu_torch.bench.cli [quick|full|demo <method> <size>|
                                           multiprobe|pcaf|multithread]
                                          [--device cpu]
It runs on the CUDA card unless --device (or main(argv, device=...)) names
another device.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from hnsw_tpu_torch.bench.harness import (measure_build, run_recall_benchmark,
                                          run_search_benchmark)
from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.io.loader import get_best_available_data
from hnsw_tpu_torch.models import FAMILIES
from hnsw_tpu_torch.models.flat import FlatIndex

# families in the reference's build-all order (bench.clj:186-252)
QUICK_FAMILIES = ["hybrid_lsh", "ivf_flat", "partitioned_hnsw", "lightning",
                  "pcaf", "ivf_hnsw", "hnsw"]
FULL_FAMILIES = ["flat", "hybrid_lsh", "ivf_flat", "partitioned_hnsw",
                 "lightning", "pcaf", "hnsw"]


def load_or_generate(n: int, dim: int = 768):
    """Real corpus if present (data_loader.clj fallback chain), else seeded
    clustered synthetic."""
    found = get_best_available_data()
    if found:
        pairs, _, _, path = found
        print(f"corpus: {path} ({len(pairs)} vectors)")
        data = np.stack([p[1] for p in pairs[:n]])
        return data
    print(f"corpus: synthetic clustered {n}x{dim} (seed 42)")
    return generate_vectors(n, dim, distribution="clustered",
                            num_clusters=64, noise=0.3)


def _bench_family(fam: str, data, k=10, mode="balanced", device=None):
    idx, secs = measure_build(lambda: FAMILIES[fam](data, device=device))
    exact = FlatIndex(idx.corpus)
    rec = run_recall_benchmark(idx, data, k=k, mode=mode, num_queries=64,
                               exact_index=exact)
    perf = run_search_benchmark(idx, data[:512], k=k, mode=mode,
                                batch_size=256, iters=5,
                                single_query_iters=10)
    print(f"{fam:18s} build {secs:7.2f}s  recall@{k} {rec['recall_at_k']:.3f}"
          f"  QPS(batch) {perf['qps_batched']:10.0f}"
          f"  p50 {perf['p50_ms']:.3f}ms p99 {perf['p99_ms']:.3f}ms")
    return {"family": fam, "build_s": secs, **rec, **perf}


def quick_benchmark(n: int = 1000, device=None):
    """1k-subset sweep across families (bench.clj:316-366)."""
    data = load_or_generate(n)
    print(f"== quick benchmark ({len(data)} vectors x {data.shape[1]}) ==")
    return [_bench_family(f, data, device=device) for f in QUICK_FAMILIES]


def full_benchmark(n: int = 31173, device=None):
    """Whole-corpus benchmark, fast-building families (bench.clj:368-429)."""
    data = load_or_generate(n)
    print(f"== full benchmark ({len(data)} vectors x {data.shape[1]}) ==")
    return [_bench_family(f, data, device=device) for f in FULL_FAMILIES]


def demo(method: str, size: int, device=None):
    data = load_or_generate(size)
    print(f"== demo {method} on {len(data)} vectors ==")
    return _bench_family(method, data, device=device)


def multiprobe_benchmark(n: int = 5000, device=None):
    """LSH probe/radius sweep (bench.clj:772-846)."""
    data = load_or_generate(n)
    idx, secs = measure_build(lambda: FAMILIES["hybrid_lsh"](
        data, device=device))
    exact = FlatIndex(idx.corpus)
    print(f"== LSH multiprobe sweep (build {secs:.2f}s) ==")
    out = []
    for mode in ("turbo", "fast", "balanced", "accurate", "precise"):
        rec = run_recall_benchmark(idx, data, mode=mode, num_queries=64,
                                   exact_index=exact)
        perf = run_search_benchmark(idx, data[:256], mode=mode,
                                    batch_size=128, iters=5,
                                    single_query_iters=5)
        print(f"  {mode:9s} recall {rec['recall_at_k']:.3f} "
              f"QPS {perf['qps_batched']:.0f}")
        out.append({"mode": mode, **rec, **perf})
    return out


def pcaf_benchmark(n: int = 5000, device=None):
    """PCAF k-filter mode sweep (bench.clj:848-928)."""
    data = load_or_generate(n)
    idx, secs = measure_build(lambda: FAMILIES["pcaf"](data, device=device))
    exact = FlatIndex(idx.corpus)
    print(f"== PCAF sweep (build {secs:.2f}s) ==")
    out = []
    for mode in ("turbo", "fast", "balanced", "accurate", "precise"):
        rec = run_recall_benchmark(idx, data, mode=mode, num_queries=64,
                                   exact_index=exact)
        print(f"  {mode:9s} recall {rec['recall_at_k']:.3f}")
        out.append({"mode": mode, **rec})
    return out


def multithread_benchmark(n: int = 10000, device=None):
    """Batch-size scaling, the analogue of thread scaling
    (parallel_search.clj:97-147; BENCHMARK_SUMMARY thread table)."""
    data = load_or_generate(n)
    idx, _ = measure_build(lambda: FAMILIES["hnsw"](data, device=device))
    print("== batch scaling (analogue of thread scaling) ==")
    out = []
    for b in (1, 8, 32, 128, 512, 2048):
        perf = run_search_benchmark(idx, data[: max(b, 64)], batch_size=b,
                                    iters=5, single_query_iters=3)
        print(f"  batch {b:5d}: QPS {perf['qps_batched']:10.0f} "
              f"({perf['per_query_ms_batched']:.4f} ms/query)")
        out.append({"batch": b, **perf})
    return out


def main(argv: Optional[list] = None, device=None):
    args = list(argv if argv is not None else sys.argv[1:])
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    args = args or ["quick"]
    cmd = args[0]
    if cmd == "quick":
        quick_benchmark(int(args[1]) if len(args) > 1 else 1000,
                        device=device)
    elif cmd == "full":
        full_benchmark(int(args[1]) if len(args) > 1 else 31173,
                       device=device)
    elif cmd == "demo":
        demo(args[1] if len(args) > 1 else "hnsw",
             int(args[2]) if len(args) > 2 else 5000, device=device)
    elif cmd == "multiprobe":
        multiprobe_benchmark(device=device)
    elif cmd == "pcaf":
        pcaf_benchmark(device=device)
    elif cmd == "multithread":
        multithread_benchmark(device=device)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

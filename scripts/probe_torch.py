#!/usr/bin/env python3
"""The PyTorch / CUDA twin of the TPU probe scripts _probe_r4e.py,
_probe_r4f.py, _probe_r5a.py and _probe_r5c.py, on one CUDA card.

    python3 scripts/probe_torch.py [floor library bucket int8 part ivfh]

Stages (all by default):
  floor    every matmul floor of hnsw_tpu_torch/ops/probes.py at the probes'
           shapes: bf16 mm_only / mm_only_nt / mm_only_kmajor at B=1024
           (r4e, r4f) and mm_only at bucket_topk's B=4096 over its
           31,744-row pack; int8 matmul_only (r5a) and matmul_min (r5c) at
           B=4096, nt=2048. The probes' bt / nt sweeps have no counterpart:
           the CUDA floors run one 64 x 128 tile loop.
  library  one PyTorch call per floor reading: r4f's NT and NN
           torch.matmul + column-group sum, and torch._int_mm + slice / min
           at B=4096.
  bucket   bucket_topk (B=1024, r4e / r4f), int8_bucket_topk and
           int8_packed_topk (B=4096, r5a), k=10, whole wrappers.
  int8     r4e's FlatIndex int8_fetch in {None, 16, 10} sweep: recall@10
           over 1,024 corpus queries and QPS at B=1024.
  part     r4e's partitioned HNSW (8 partitions) build (cold and warm) and
           balanced / accurate / precise, then r5c's ef in {400, 420, 450,
           500} at expand 8.
  ivfh     r5c's IVF-HNSW (32 clusters) at expand 4 and 8, balanced /
           accurate / precise.

The corpus is the 31,173 x 768 embedding-like stand-in of bench.py's
make_corpus (generate_vectors, 64 clusters, seed 42); the r5a / r5c probes
drew theirs on the TPU with jax.random, which this host recipe does not
reproduce. Kernel times are medians of 20 CUDA-event timings; QPS comes from
the ported bench harness (qps_device, the two-point slope). Every reading is
one JSON line carrying the card's name and power limit. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hnsw_tpu_torch.bench.kernels import (  # noqa: E402  (sets TF32 off)
    FLOOR_NT, floor_calls, median_ms, probe_operands)

STAGES = ("floor", "library", "bucket", "int8", "part", "ivfh")
N, DIM, SEED, K = 31173, 768, 42, 10


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


CARD = None


def log(**kw):
    print(json.dumps({"card": CARD, **kw}), flush=True)


def stage_floor(x):
    for variant, call in floor_calls(x).items():
        log(stage="floor", variant=variant, ms=median_ms(call))


def stage_library(x):
    for variant, call in floor_calls(x).items():
        log(stage="library", variant=variant,
            ms=median_ms(call.library, reps=10))


def stage_bucket(x):
    from hnsw_tpu_torch.ops import scan
    n = x["n"]
    for variant, fn in (
            ("bucket_topk_b1024", lambda: scan.bucket_topk(
                x["v"], x["vsq"], x["q1024"], n, k=K, metric="cosine",
                bt=1024, nt=1024)),
            ("int8_bucket_topk_b4096", lambda: scan.int8_bucket_topk(
                x["v8"], x["vs"], x["vsq"], x["q8"], x["qmeta"], n, k=K,
                metric="cosine", bt=256, nt=FLOOR_NT)),
            ("int8_packed_topk_b4096", lambda: scan.int8_packed_topk(
                x["v8"], x["vs"], x["vsq"], x["q8"], x["qmeta"], n, k=K,
                metric="cosine", bt=256, nt=FLOOR_NT))):
        log(stage="bucket", variant=variant, ms=median_ms(fn))


def stage_int8(x, data, exact):
    from hnsw_tpu_torch.bench import run_recall_benchmark, run_search_benchmark
    from hnsw_tpu_torch.models import FlatIndex
    for fetch in (None, 16, 10):
        idx = FlatIndex(x["corpus"], precision="int8", int8_fetch=fetch)
        rec = run_recall_benchmark(idx, data, k=K, num_queries=1024,
                                   exact_index=exact)
        perf = run_search_benchmark(idx, data[:1024], k=K, batch_size=1024,
                                    warmup=2, iters=8, single_query_iters=0)
        log(stage="int8", fetch=fetch, recall=rec["recall_at_k"],
            qps=perf["qps_device"])


def _family(idx, data, exact, label, **kw):
    """recall@10 of 1,024 corpus rows and qps_device at B=1024 (r5c's
    measure)."""
    from hnsw_tpu_torch.bench import run_search_benchmark

    class View:
        """r5c's V: fixed search options over a built index."""
        corpus = idx.corpus

        def search_batch(self, q, k, mode=None):
            return idx.search_batch(q, k, kw.get("mode", "balanced"),
                                    **{a: b for a, b in kw.items()
                                       if a != "mode"})

    _, er = exact.search_batch(data[:1024], K)
    _, ar = View().search_batch(data[:1024], K)
    hit = (ar[:, :, None] == er[:, None, :]).any(-1) & (ar >= 0)
    rec = float(hit.float().sum(-1).mean()) / K
    perf = run_search_benchmark(View(), data[:1024], k=K, batch_size=1024,
                                warmup=1, iters=4, single_query_iters=0)
    log(stage=label, **kw, recall=rec, qps=perf["qps_device"])


def stage_part(x, data, exact):
    import hnsw_tpu_torch as ht
    from hnsw_tpu_torch.bench import (measure_build, run_recall_benchmark,
                                      run_search_benchmark)
    corpus = x["corpus"]
    _, cold = measure_build(
        lambda: ht.build_partitioned_hnsw(corpus, num_partitions=8))
    part, warm = measure_build(
        lambda: ht.build_partitioned_hnsw(corpus, num_partitions=8))
    log(stage="part_build", cold_s=cold, warm_s=warm)
    for mode in ("balanced", "accurate", "precise"):
        rec = run_recall_benchmark(part, data, k=K, mode=mode,
                                   num_queries=1024, exact_index=exact)
        perf = run_search_benchmark(part, data[:1024], k=K, mode=mode,
                                    batch_size=1024, warmup=2, iters=6,
                                    single_query_iters=0)
        log(stage="part", mode=mode, recall=rec["recall_at_k"],
            qps=perf["qps_device"])
    part.expand = 8
    for ef in (400, 420, 450, 500):
        _family(part, data, exact, "part_ef", ef=ef)


def stage_ivfh(x, data, exact):
    import hnsw_tpu_torch as ht
    ivfh = ht.build_ivf_hnsw_index(x["corpus"], num_partitions=32)
    for e in (4, 8):
        ivfh.expand = e
        for mode in ("balanced", "accurate", "precise"):
            _family(ivfh, data, exact, f"ivf_hnsw_e{e}", mode=mode)


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("probe_torch: no CUDA device", file=sys.stderr)
        return 1
    stages = set(sys.argv[1:]) or set(STAGES)
    unknown = stages - set(STAGES)
    if unknown:
        print(f"probe_torch: unknown stages {sorted(unknown)}; "
              f"one of {STAGES}", file=sys.stderr)
        return 2
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import FlatIndex

    CARD = card()
    t0 = time.time()
    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    x = probe_operands(data)
    exact = FlatIndex(x["corpus"])
    torch.cuda.synchronize()
    log(stage="staged", s=time.time() - t0)
    for stage in STAGES:
        if stage not in stages:
            continue
        if stage in ("int8", "part", "ivfh"):
            globals()[f"stage_{stage}"](x, data, exact)
        else:
            globals()[f"stage_{stage}"](x)
    log(stage="done", total_s=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (hnsw_tpu_torch) end to end on one card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build the kernels of hnsw_tpu_torch/csrc with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path, and time kernel, plain version and a PyTorch
     yardstick that the port never calls;
  4. the main path at full width: a 31,173 x 768 embedding-like corpus
     (cosine), the exact f32 flat index as ground truth, the bf16 and int8
     flat scans, the HNSW build (M=16) and HNSW serving with the bf16 and
     the int8 neighbour pack. Launch counts are zeroed just before and read
     just after, and every kernel must have run.
Then one JSON line of per-kernel records, and as the last line
{"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 and int8
# tensor-core operations/s. Used for bound_ms, the least time the card could
# take for a call's bytes or operations.
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
INT8_OPS_S = 1979e12

N, DIM, SEED = 31173, 768, 42
K = 10
REPS = 5   # timed batches per family on the main path
ENTRY_SAMPLE = 2048   # HNSW sampled-entry rows for the serving bars


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms over `reps` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_rows(n: int, tile: int = 128) -> int:
    """Corpus rows a bucket scan must read: the 128-row tiles (one row per
    bucket) that hold a row below n. Rows past them key BIG and need no
    work, so the bounds count neither their bytes nor their products."""
    return -(-n // tile) * tile


def recall(rows, exact_rows) -> float:
    hit = (rows[:, :, None] == exact_rows[:, None, :]).any(-1)
    hit = hit & (rows >= 0)
    return float(hit.float().sum(-1).mean() / exact_rows.shape[1])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_hop_kernels(torch, records):
    from hnsw_tpu_torch.ops import hop

    b, e, m0, d, n_pad = 1024, 4, 32, DIM, 31176
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    queries = torch.randn(b, d, generator=g, device=dev)
    sel = torch.randint(-1, n_pad, (b, e), generator=g, device=dev,
                        dtype=torch.int32)
    uniq = int(torch.unique(torch.clamp(sel, min=0)).numel())
    pack = torch.randn(n_pad, m0, d, generator=g, device=dev).to(torch.bfloat16)
    codes = torch.randint(-127, 128, (n_pad, m0, d), generator=g, device=dev,
                          dtype=torch.int8)
    rows = torch.clamp(sel, min=0).long()

    for name, tensor, fn, plain, esize in (
            ("hop_score", pack, hop.hop_score, hop.hop_score_plain, 2),
            ("hop_score_int8", codes, hop.hop_score_int8,
             hop.hop_score_int8_plain, 1)):
        got = fn(tensor, queries, sel)
        want = plain(tensor, queries, sel)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        # f32 sums of D products taken in another order: 1e-4 of the largest
        # magnitude (csq for bf16 is checked the same way)
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        for err, w in zip(errs, want):
            check(err <= 1e-4 * float(w.abs().max()),
                  f"{name} disagrees with its plain version: {errs}")
        ms = time_ms(lambda: fn(tensor, queries, sel))
        plain_ms = time_ms(lambda: plain(tensor, queries, sel), reps=5)
        qb = queries.to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.einsum(
            "bd,bemd->bem", qb, tensor[rows].to(torch.bfloat16)), reps=5)
        outs = 2 if name == "hop_score" else 1
        nbytes = uniq * m0 * d * esize + b * d * 4 + b * e * 4 \
            + outs * b * e * m0 * 4
        ops = 2 * outs * b * e * m0 * d
        bms, by = bound(nbytes, ops, BF16_OPS_S)
        say("kernel", name=name, shape=f"B={b},E={e},M0={m0},D={d},"
            f"N_pad={n_pad}", max_abs_err=max(errs),
            tol="1e-4*max|plain|", kernel_ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
        records[name] = dict(
            name=name, route="cuda", source="hnsw_tpu_torch/csrc/hop.cu",
            replaces=("hnsw_tpu/ops/pallas_hop.py:152" if name == "hop_score"
                      else "hnsw_tpu/ops/pallas_hop.py:276"),
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
    del pack, codes


def check_scan_kernels(torch, data, records):
    from hnsw_tpu_torch.models.flat import quantize_rows
    from hnsw_tpu_torch.ops import scan
    from hnsw_tpu_torch.types import Corpus

    b, d = 4096, DIM
    for metric in ("cosine", "euclidean", "dot"):
        corpus = Corpus.from_array(data, metric=metric)
        n_pad = 31744
        vec = torch.nn.functional.pad(corpus.vectors.to(torch.bfloat16),
                                      (0, 0, 0, n_pad - corpus.n_pad))
        vsq = torch.nn.functional.pad(corpus.sq_norms, (0, n_pad - corpus.n_pad))
        q = corpus.pad_queries(data[:b]).to(torch.bfloat16)
        vkey = scan.bf16_vkey(vsq, metric)
        kd, kr = scan.bucket_bank(vec, vkey, q, corpus.n, metric=metric)
        pd, pr = scan.bucket_bank_plain(vec, vkey, q, corpus.n, metric=metric)
        dk, rk = scan.bucket_topk(vec, vsq, q, corpus.n, k=K, metric=metric,
                                  bt=1024)
        torch.cuda.synchronize()
        live = (pd < 1e29) & (kd < 1e29)
        err = float((kd - pd).abs()[live].max())
        # keys are f32 sums of D bf16 products in another order
        check(err <= 1e-4, f"bucket_topk {metric}: key error {err}")
        pk = torch.sort(pd, dim=-1, stable=True)
        prow = torch.gather(pr, -1, pk.indices[:, :K])
        agree = float((rk == prow).float().mean())
        check(agree >= 0.999, f"bucket_topk {metric}: row agreement {agree}")
        check(bool(torch.isfinite(dk).all()) and tuple(dk.shape) == (b, K),
              "bucket_topk output")
        fields = dict(name="bucket_topk", metric=metric,
                      shape=f"B={b},N_pad={n_pad},D={d},k={K}",
                      max_abs_err=err, tol=1e-4, row_agreement=agree,
                      row_agreement_bar=0.999)
        if metric == "cosine":
            ms = time_ms(lambda: scan.bucket_bank(vec, vkey, q, corpus.n,
                                                  metric=metric))
            plain_ms = time_ms(lambda: scan.bucket_bank_plain(
                vec, vkey, q, corpus.n, metric=metric), reps=5)
            lib_ms = time_ms(lambda: torch.topk(
                -torch.matmul(q, vec.T).float() * vkey, K, dim=-1), reps=10)
            live = live_rows(corpus.n)
            bms, by = bound(live * d * 2 + b * d * 2 + live * 4 + b * 256 * 8,
                            2 * b * live * d, BF16_OPS_S)
            fields.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bms, bound_by=by)
            records["bucket_topk"] = dict(
                name="bucket_topk", route="cuda",
                source="hnsw_tpu_torch/csrc/scan.cu",
                replaces="hnsw_tpu/ops/pallas_scan.py:279",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        say("kernel", **fields)
        del vec

    corpus = Corpus.from_array(data, metric="cosine")
    n_pad = 32768
    v8, vscale = quantize_rows(corpus.vectors)
    v8 = torch.nn.functional.pad(v8, (0, 0, 0, n_pad - corpus.n_pad))
    vscale = torch.nn.functional.pad(vscale, (0, n_pad - corpus.n_pad))
    vsq = torch.nn.functional.pad(corpus.sq_norms, (0, n_pad - corpus.n_pad))
    q8, qscale = quantize_rows(corpus.pad_queries(data[:b]))
    qmeta = torch.stack([qscale, torch.zeros_like(qscale)], dim=1)
    vkey = scan.int8_vkey(vscale, vsq, "cosine")
    kd, kr = scan.int8_bucket_bank(v8, vkey, vscale, q8, qscale, corpus.n,
                                   metric="cosine")
    pd, pr = scan.int8_bucket_bank_plain(v8, vkey, vscale, q8, qscale,
                                         corpus.n, metric="cosine")
    torch.cuda.synchronize()
    live = (pd < 1e29) & (kd < 1e29)
    err = float((kd - pd).abs()[live].max())
    # int32 dots are exact on both sides; the key is one f32 multiply
    check(err <= 1e-3, f"int8_bucket_topk: key error {err}")
    pk = torch.sort(pd, dim=-1, stable=True)
    for k in (16, 10):
        dk, rk = scan.int8_bucket_topk(v8, vscale, vsq, q8, qmeta, corpus.n,
                                       k=k, metric="cosine", bt=256,
                                       nt=2048)
        prow = torch.gather(pr, -1, pk.indices[:, :k])
        agree = float((rk == prow).float().mean())
        check(agree >= 0.999, f"int8_bucket_topk k={k}: agreement {agree}")
        say("kernel", name="int8_bucket_topk", metric="cosine",
            shape=f"B={b},N_pad={n_pad},D={d},k={k}", max_abs_err=err,
            tol=1e-3, row_agreement=agree, row_agreement_bar=0.999)
    ms = time_ms(lambda: scan.int8_bucket_bank(
        v8, vkey, vscale, q8, qscale, corpus.n, metric="cosine"))
    plain_ms = time_ms(lambda: scan.int8_bucket_bank_plain(
        v8, vkey, vscale, q8, qscale, corpus.n, metric="cosine"), reps=5)
    v8t = v8.T
    lib_ms = time_ms(lambda: torch.topk(
        -torch._int_mm(q8, v8t).float() * vkey, K, dim=-1), reps=10)
    live = live_rows(corpus.n)
    bms, by = bound(live * d + b * d + live * 8 + b * 4 + b * 256 * 8,
                    2 * b * live * d, INT8_OPS_S)
    say("kernel", name="int8_bucket_topk", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by)
    records["int8_bucket_topk"] = dict(
        name="int8_bucket_topk", route="cuda",
        source="hnsw_tpu_torch/csrc/scan.cu",
        replaces="hnsw_tpu/ops/pallas_scan.py:395",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def qps(torch, fn, b: int) -> float:
    """Queries per second: median host time of REPS synchronized batches
    (after one more untimed batch)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return b / statistics.median(times)


def main_path(torch, data):
    from hnsw_tpu_torch.models import FlatIndex, HNSWIndex, build_hnsw_index
    from hnsw_tpu_torch.ops import hop, scan
    from hnsw_tpu_torch.types import Corpus

    kernels = (hop.hop_score, hop.hop_score_int8, scan.bucket_topk,
               scan.int8_bucket_topk)
    corpus = Corpus.from_array(data, metric="cosine")
    exact = FlatIndex(corpus)
    qf = corpus.pad_queries(data[:4096])
    _, truth = exact.search_batch(qf, K)
    torch.cuda.synchronize()

    for fn in kernels:
        fn.launches = 0
    batches = {}

    for label, index, bars in (
            ("flat_bf16", FlatIndex(corpus, precision="bf16"), 0.98),
            ("flat_int8", FlatIndex(corpus, precision="int8"), 0.98),
            ("flat_int8_coarse", FlatIndex(corpus, precision="int8",
                                           int8_fetch=0), 0.95)):
        d, r = index.search_batch(qf, K)
        rec = recall(r, truth)
        check(rec >= bars, f"{label} recall {rec} < {bars}")
        check(bool(torch.isfinite(d).all()), f"{label} non-finite distances")
        rate = qps(torch, lambda: index.search_batch(qf, K), len(qf))
        batches[label] = REPS + 2
        say("main", family=label, batch=len(qf), recall_at_10=rec, qps=rate)

    t0 = time.perf_counter()
    hnsw = build_hnsw_index(corpus, M=16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    say("main", hnsw_build_seconds=build_s, n=corpus.n, dim=DIM,
        bridge_edges=hnsw.graph.n_bridges, max_level=hnsw.graph.max_level)

    q = qf[:1024]
    t1024 = truth[:1024]
    # At the default entry sample (512 evenly spaced rows) 14 of these 1024
    # queries do not get their own row first; the JAX package, searching
    # the same graph, returns identical rows and misses the same queries
    # (scripts/entry_sample_card.py, then scripts/entry_sample_reference.py).
    # The default is run and reported; the bars are held at
    # entry_sample=ENTRY_SAMPLE.
    served = HNSWIndex(corpus, hnsw.graph, entry_sample=ENTRY_SAMPLE)
    served_int8 = HNSWIndex(corpus, hnsw.graph, entry_sample=ENTRY_SAMPLE,
                            pack_precision="int8")
    for label, index, mode, bars in (
            ("hnsw_bf16_pack_sample512", hnsw, "turbo", False),
            ("hnsw_bf16_pack_sample512", hnsw, "balanced", False),
            ("hnsw_bf16_pack", served, "turbo", False),
            ("hnsw_bf16_pack", served, "balanced", True),
            ("hnsw_int8_pack", served_int8, "balanced", True)):
        d, r, hops = index.search_batch(q, K, mode, debug_hops=True)
        rec = recall(r, t1024)
        self_first = float((r[:, 0].cpu() == torch.arange(len(q))).float()
                           .mean())
        check(bool((r >= 0).all()), f"{label} {mode}: row -1 in the result")
        check(bool(torch.isfinite(d).all()), f"{label} non-finite distances")
        rate = qps(torch, lambda: index.search_batch(q, K, mode), len(q))
        batches[f"{label}_{mode}"] = REPS + 2
        say("main", family=label, mode=mode, batch=len(q), recall_at_10=rec,
            hops=hops, self_first=self_first, qps=rate)
        if bars:
            check(rec >= 0.95, f"{label} {mode}: recall {rec}")
            check(self_first >= 0.99, f"{label} {mode}: self first "
                  f"{self_first}")

    launches = {fn.__name__: fn.launches for fn in kernels}
    say("main", launches=json.dumps(launches), batches=json.dumps(batches))
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _cuda.build_all()
    for src in _cuda.SOURCES:
        _cuda.library(src)
    say("build", seconds=time.perf_counter() - t0)
    for src in _cuda.SOURCES:
        for line in _cuda.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)

    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    records = {}
    check_hop_kernels(torch, records)
    check_scan_kernels(torch, data, records)
    torch.cuda.empty_cache()

    launches = main_path(torch, data)
    out = []
    for name in ("hop_score", "hop_score_int8", "bucket_topk",
                 "int8_bucket_topk"):
        rec = records[name]
        rec["launches"] = launches[name]
        out.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

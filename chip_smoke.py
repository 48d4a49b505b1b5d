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
     the int8 neighbour pack;
  5. the API path at full width (hnsw_tpu_torch.build_index, save_index,
     load_index, Index): flat indexes with scan_kernel "sweep" (bf16, int8)
     and "packed" (int8), the packed DOT guard on an unnormalized corpus,
     save / load in .npz and .idx, and a stateful HNSW index of 30,149 rows
     grown by one wave insert of 1,024;
  6. the probe path at full width (the twin of scripts/_probe_r4e.py, r4f,
     r5a and r5c): the four matmul floors run at the probes' shapes, their
     phase-3 times printed beside those of the scan kernels they bound,
     then partitioned HNSW (8
     partitions) and IVF-HNSW (32 clusters) built, searched at B=1024
     through the hop_score kernel at hop width 256, measured with the
     ported bench harness (recall@10 against the exact flat index, QPS,
     build seconds), and saved and loaded with identical rows.
Phases 4, 5 and 6 each zero the launch counts just before and read them just
after; each must have run its kernels, and all eleven together. Then one
JSON line of per-kernel records, and as the last line
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
KERNELS = ("hop_score", "hop_score_int8", "bucket_topk", "int8_bucket_topk",
           "exact_topk_sweep", "int8_sweep_topk", "int8_packed_topk",
           "mm_only", "mm_only_kmajor", "matmul_only", "matmul_min")
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


def _row_agreement(got_r, want_r) -> float:
    return float((got_r == want_r).float().mean())


def check_sweep_kernels(torch, data, records):
    """The two sweep kernels against their plain versions, in every metric,
    at FlatIndex's shapes: bf16 on the 1024-padded pack (bt 512), int8 on
    the 2048-padded int8 pack (bt 256, nt 1024) at k = 10 + 6 (the re-rank
    fetch)."""
    from hnsw_tpu_torch.models.flat import quantize_rows
    from hnsw_tpu_torch.ops import scan
    from hnsw_tpu_torch.types import Corpus

    b, d = 4096, DIM
    live = live_rows(N)
    for int8, name, n_pad, k, tol in ((False, "exact_topk_sweep", 31744, K,
                                        1e-4),
                                       (True, "int8_sweep_topk", 32768, K + 6,
                                        1e-3)):
        for metric in ("cosine", "euclidean", "dot"):
            corpus = Corpus.from_array(data, metric=metric)
            extra = n_pad - corpus.n_pad
            vsq = torch.nn.functional.pad(corpus.sq_norms, (0, extra))
            qf = corpus.pad_queries(data[:b])
            if int8:
                v8, vscale = quantize_rows(corpus.vectors)
                v8 = torch.nn.functional.pad(v8, (0, 0, 0, extra))
                vscale = torch.nn.functional.pad(vscale, (0, extra))
                q8, qscale = quantize_rows(qf)
                qmeta = torch.stack([qscale, (qf * qf).sum(1)], dim=1)
                args = (v8, vscale, vsq, q8, qmeta, corpus.n)

                def kern():
                    return scan.int8_sweep_topk(*args, k=k, metric=metric,
                                                bt=256, nt=1024)

                def plain():
                    return scan.int8_sweep_topk_plain(*args, k=k,
                                                      metric=metric, nt=1024)
            else:
                vec = torch.nn.functional.pad(
                    corpus.vectors.to(torch.bfloat16), (0, 0, 0, extra))
                qb = qf.to(torch.bfloat16)
                args = (vec, vsq, qb, corpus.n)

                def kern():
                    return scan.exact_topk_sweep(*args, k=k, metric=metric,
                                                 bt=512)

                def plain():
                    return scan.exact_topk_sweep_plain(*args, k=k,
                                                       metric=metric)
            kd, kr = kern()
            pd, pr = plain()
            torch.cuda.synchronize()
            check(bool((kr >= 0).all()) and bool((kr < corpus.n).all()),
                  f"{name} {metric}: a row outside [0, n)")
            # euclidean: compared as d^2, the domain where the f32 sum-order
            # error is additive (sqrt amplifies it near d = 0)
            p = 2 if metric == "euclidean" else 1
            err = float((kd ** p - pd ** p).abs().max())
            agree = _row_agreement(kr, pr)
            check(err <= tol, f"{name} {metric}: distance error {err}")
            check(agree >= 0.999, f"{name} {metric}: row agreement {agree}")
            fields = dict(name=name, metric=metric,
                          shape=f"B={b},N_pad={n_pad},D={d},k={k}",
                          max_abs_err=err, tol=tol, row_agreement=agree,
                          row_agreement_bar=0.999)
            if metric == "cosine":
                ms = time_ms(kern)
                plain_ms = time_ms(plain, reps=3, warmup=1)
                if int8:
                    v8t = v8.T
                    qs = qmeta[:, 0:1]

                    def lib():
                        dots = torch._int_mm(q8, v8t).float() * qs * vscale
                        dist = 1.0 - dots / torch.sqrt(torch.clamp(
                            qmeta[:, 1:2] * vsq, min=1e-12))
                        return torch.topk(dist, k, dim=-1, largest=False)
                    nbytes = live * d + b * d + live * 8 + b * 8 + b * k * 8
                    bms, by = bound(nbytes, 2 * b * live * d, INT8_OPS_S)
                else:
                    q_sq = (qb.float() ** 2).sum(1, keepdim=True)

                    def lib():
                        dots = torch.matmul(qb, vec.T).float()
                        dist = 1.0 - dots / torch.sqrt(torch.clamp(
                            q_sq * vsq, min=1e-12))
                        return torch.topk(dist, k, dim=-1, largest=False)
                    nbytes = live * d * 2 + b * d * 2 + live * 4 + b * k * 8
                    bms, by = bound(nbytes, 2 * b * live * d, BF16_OPS_S)
                lib_ms = time_ms(lib, reps=10)
                fields.update(kernel_ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=bms, bound_by=by)
                records[name] = dict(
                    name=name, route="cuda",
                    source="hnsw_tpu_torch/csrc/sweep.cu",
                    replaces=("hnsw_tpu/ops/pallas_scan.py:654" if int8
                              else "hnsw_tpu/ops/pallas_scan.py:123"),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)
            else:
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
            say("kernel", **fields)


def check_packed_kernel(torch, data, records):
    """The packed int8 kernel against its plain version (cosine and dot) at
    FlatIndex's shapes (the 2048-padded int8 pack, bt 256, nt 2048): bank
    keys bit for bit, top-k rows by agreement (split banks may tie)."""
    from hnsw_tpu_torch.models.flat import quantize_rows
    from hnsw_tpu_torch.ops import scan
    from hnsw_tpu_torch.types import Corpus

    b, d, n_pad = 4096, DIM, 32768
    live = live_rows(N)
    for metric in ("cosine", "dot"):
        corpus = Corpus.from_array(data, metric=metric)
        extra = n_pad - corpus.n_pad
        v8, vscale = quantize_rows(corpus.vectors)
        v8 = torch.nn.functional.pad(v8, (0, 0, 0, extra))
        vscale = torch.nn.functional.pad(vscale, (0, extra))
        vsq = torch.nn.functional.pad(corpus.sq_norms, (0, extra))
        qf = corpus.pad_queries(data[:b])
        q8, qscale = quantize_rows(qf)
        qmeta = torch.stack([qscale, (qf * qf).sum(1)], dim=1)
        nvkey = -scan.int8_vkey(vscale, vsq, metric)
        kd, kr = scan.int8_packed_bank(v8, nvkey, q8, corpus.n)
        pd, pr = scan.int8_packed_bank_plain(v8, nvkey, q8, corpus.n)
        torch.cuda.synchronize()
        both = (kd < 1e29) & (pd < 1e29)
        check(bool(((kd < 1e29) == (pd < 1e29)).all()),
              f"int8_packed_topk {metric}: live bank entries differ")
        # the two smallest keys of a bucket do not depend on the order the
        # tiles are folded in; only a tied key's row may
        err = float((kd - pd)[both].abs().max())
        check(err == 0.0, f"int8_packed_topk {metric}: key error {err}")
        args = (v8, vscale, vsq, q8, qmeta, corpus.n)
        for k in (K + 6, K):
            dk, rk = scan.int8_packed_topk(*args, k=k, metric=metric)
            pk = torch.sort(pd, dim=-1, stable=True)
            prow = torch.gather(pr, -1, pk.indices[:, :k])
            agree = _row_agreement(rk, prow)
            check(agree >= 0.999,
                  f"int8_packed_topk {metric} k={k}: agreement {agree}")
            say("kernel", name="int8_packed_topk", metric=metric,
                shape=f"B={b},N_pad={n_pad},D={d},k={k}", max_abs_err=err,
                tol=0, row_agreement=agree, row_agreement_bar=0.999)
        if metric == "cosine":
            ms = time_ms(lambda: scan.int8_packed_bank(v8, nvkey, q8,
                                                       corpus.n))
            plain_ms = time_ms(lambda: scan.int8_packed_bank_plain(
                v8, nvkey, q8, corpus.n), reps=5)
            v8t = v8.T
            lib_ms = time_ms(lambda: torch.topk(
                torch._int_mm(q8, v8t).float() * nvkey, K, dim=-1,
                largest=False), reps=10)
            bms, by = bound(live * d + b * d + live * 4 + b * 256 * 8,
                            2 * b * live * d, INT8_OPS_S)
            say("kernel", name="int8_packed_topk", kernel_ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)
            records["int8_packed_topk"] = dict(
                name="int8_packed_topk", route="cuda",
                source="hnsw_tpu_torch/csrc/scan.cu",
                replaces="hnsw_tpu/ops/pallas_scan.py:547",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


# the TPU kernel each floor reading stands for, and what its library call is
FLOOR_RECORDS = {
    "mm_only_b1024": ("mm_only", "scripts/_probe_r4e.py:119",
                      "torch.matmul NT + column-group sum"),
    "mm_only_nt_b1024": ("mm_only_nt", "scripts/_probe_r4f.py:95",
                         "torch.matmul NT + column-group sum"),
    "mm_only_kmajor_b1024": ("mm_only_kmajor", "scripts/_probe_r4f.py:95",
                             "torch.matmul NN + column-group sum"),
    "mm_only_b4096_n31744": (None, None,
                             "torch.matmul NT + column-group sum"),
    "matmul_only_b4096_nt2048": ("matmul_only", "scripts/_probe_r5a.py:88",
                                 "torch._int_mm + slice"),
    "matmul_min_b4096_nt2048": ("matmul_min", "scripts/_probe_r5c.py:79",
                                "torch._int_mm + min over g"),
}


def check_probe_kernels(torch, data, records):
    """The four floors against their plain versions at the probes' shapes,
    and mm_only also at bucket_topk's (B=4096 over its 31,744-row pack):
    int32 outputs bit for bit, f32 column sums within 1e-3 * max |out|
    (exact bf16 products summed in another order). Returns each reading's
    kernel time by its label in floor_calls."""
    from hnsw_tpu_torch.bench.kernels import floor_calls, probe_operands

    d = DIM
    live = live_rows(N)
    floor_ms = {}
    for label, call in floor_calls(probe_operands(data)).items():
        name, replaces, lib_what = FLOOR_RECORDS[label]
        got, want = call(), call.run_plain()
        torch.cuda.synchronize()
        b = call.args[0].shape[0]
        int8 = got.dtype == torch.int32
        if int8:
            check(bool(torch.equal(got, want)),
                  f"{label} differs from its plain version")
            check(bool(torch.equal(call.library(), want)),
                  f"{label}: the library yardstick computes another function")
            err, tol = 0.0, 0.0
        else:
            err = float((got - want).abs().max())
            tol = 1e-3 * float(want.abs().max())
            check(err <= tol, f"{label} disagrees with its plain version: "
                  f"{err}")
        ms = time_ms(call)
        plain_ms = time_ms(call.run_plain, reps=5)
        lib_ms = time_ms(call.library, reps=10)
        floor_ms[label] = ms
        # bf16 reads 2 bytes per element, int8 one; both form every live
        # row's products (the int8 floors too: they keep only the last
        # tile's, but run the tile loop over every row by design)
        esize = 1 if int8 else 2
        bms, by = bound(live * d * esize + b * d * esize + b * 128 * 4,
                        2 * b * live * d, INT8_OPS_S if int8 else BF16_OPS_S)
        rows = call.args[1].shape[1 if "kmajor" in label else 0]
        say("kernel", name=label, shape=f"B={b},N={rows},D={d}",
            nt=call.kwargs.get("nt"), max_abs_err=err, tol=tol, kernel_ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, library=lib_what, bound_ms=bms, bound_by=by)
        if name is not None:
            records[name] = dict(
                name=name, route="cuda",
                source="hnsw_tpu_torch/csrc/probes.cu", replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    return floor_ms


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


# ---------------------------------------------------------------------------
# phase 5: the API path
# ---------------------------------------------------------------------------

def _rows_equal(torch, a, b) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def api_path(torch, data):
    """The unified and stateful APIs at full width: flat indexes with each
    scan kernel, the DOT guard, save / load in both formats, and a stateful
    HNSW index grown by one wave insert."""
    import tempfile

    import numpy as np

    import hnsw_tpu_torch as ht
    from hnsw_tpu_torch.ops import hop, scan

    kernels = (hop.hop_score, hop.hop_score_int8, scan.bucket_topk,
               scan.int8_bucket_topk, scan.exact_topk_sweep,
               scan.int8_sweep_topk, scan.int8_packed_topk)
    for fn in kernels:
        fn.launches = 0
    qf = data[:4096]
    _, truth = ht.build_index(data, "flat").search_batch(qf, K)

    # (a) flat indexes through build_index, one per scan kernel route
    packed = None
    for p, s, fetch, bar in (("bf16", "sweep", None, 0.98),
                             ("int8", "sweep", None, 0.98),
                             ("int8", "sweep", 0, 0.95),
                             ("int8", "packed", None, 0.98),
                             ("int8", "packed", 0, 0.95)):
        idx = ht.build_index(data, "flat", precision=p, scan_kernel=s,
                             int8_fetch=fetch)
        d, r = idx.search_batch(qf, K)
        rec = recall(r, truth)
        check(rec >= bar, f"flat {p}/{s}/fetch={fetch}: recall {rec} < {bar}")
        check(bool(torch.isfinite(d).all()) and bool((r >= 0).all()),
              f"flat {p}/{s}: non-finite distance or row -1")
        rate = qps(torch, lambda: idx.search_batch(qf, K), len(qf))
        say("api", family=f"flat_{p}_{s}", int8_fetch=fetch, batch=len(qf),
            recall_at_10=rec, bar=bar, qps=rate)
        if s == "packed" and fetch is None:
            packed = (idx, r)

    # (b) an unnormalized DOT corpus: "packed" must take the bucket kernel
    scale = np.random.default_rng(SEED).uniform(50.0, 150.0, (len(data), 1))
    dot_data = (data * scale).astype(np.float32)
    _, dot_truth = ht.build_index(dot_data, "flat", metric="dot") \
        .search_batch(dot_data[:4096], K)
    before = (scan.int8_packed_topk.launches, scan.int8_bucket_topk.launches)
    dot_idx = ht.build_index(dot_data, "flat", metric="dot", precision="int8",
                             scan_kernel="packed")
    _, r = dot_idx.search_batch(dot_data[:4096], K)
    after = (scan.int8_packed_topk.launches, scan.int8_bucket_topk.launches)
    check(after == (before[0], before[1] + 1),
          f"DOT guard: launches (packed, bucket) {before} -> {after}")
    rec = recall(r, dot_truth)
    check(rec >= 0.98, f"DOT guard route: recall {rec}")
    say("api", family="flat_int8_packed_dot_unnormalized",
        kernel="int8_bucket_topk", recall_at_10=rec)

    with tempfile.TemporaryDirectory() as tmp:
        # (c) save / load: the packed flat index as .npz, HNSW as .idx
        idx, rows = packed
        t0 = time.perf_counter()
        path = ht.save_index(idx, f"{tmp}/flat_packed")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ht.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(back.corpus.device.type == "cuda" and back.scan_kernel ==
              "packed", "loaded flat index: not on the card or not packed")
        check(_rows_equal(torch, back.search_batch(qf, K)[1], rows),
              "flat packed: rows differ after reload")
        say("api", persist="npz", family="flat_int8_packed",
            save_seconds=save_s, load_seconds=load_s, rows_identical=True)

        t0 = time.perf_counter()
        hnsw = ht.build_index(data, "hnsw", M=16)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        q = qf[:1024]
        rows = hnsw.search_batch(q, K)[1]
        t0 = time.perf_counter()
        path = ht.save_index(hnsw, f"{tmp}/hnsw", format="dir")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ht.load_index(path, stream_chunk_rows=8192)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(_rows_equal(torch, back.search_batch(q, K)[1], rows),
              "hnsw: rows differ after reload")
        say("api", persist="dir", family="hnsw", stream_chunk_rows=8192,
            build_seconds=build_s, save_seconds=save_s, load_seconds=load_s,
            rows_identical=True)
        del hnsw, back

        # (d) the stateful Index: build, search, one wave insert, save, load
        n0 = len(data) - 1024
        ids = [f"doc{i}" for i in range(len(data))]
        ix = ht.Index(dimensions=DIM, index_type="hnsw", M=16)
        for i in range(n0):
            ix.add(ids[i], data[i], metadata={"row": i})
        t0 = time.perf_counter()
        check(ix.size == n0, "Index size after the first flush")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        hit = ix.search(data[5], 1)[0]
        check(hit["id"] == "doc5" and hit["metadata"] == {"row": 5},
              f"Index search: {hit}")
        ix.add_batch([(ids[i], data[i], {"row": i})
                      for i in range(n0, len(data))])
        t0 = time.perf_counter()
        check(ix.size == len(data), "Index size after the wave insert")
        torch.cuda.synchronize()
        insert_s = time.perf_counter() - t0
        new_q = data[n0:]
        _, new_truth = ht.build_index(data, "flat").search_batch(new_q, K)
        _, r = ix._impl.search_batch(new_q, K)
        rec = recall(r, new_truth)
        self_first = float((r[:, 0].cpu() == torch.arange(n0, len(data)))
                           .float().mean())
        check(rec >= 0.90, f"recall of the inserted rows {rec} < 0.90")
        hit = ix.search(data[n0 + 3], 1)[0]
        check(hit["metadata"] == {"row": n0 + 3}, f"metadata: {hit}")
        path = ix.save(f"{tmp}/stateful")
        ix2 = ht.Index.load(path)
        _, r2 = ix2._impl.search_batch(new_q, K)
        check(_rows_equal(torch, r2, r), "Index: rows differ after reload")
        same_ids = all([h["id"] for h in ix.search(data[i], K)]
                       == [h["id"] for h in ix2.search(data[i], K)]
                       for i in range(0, len(data), 997))
        check(same_ids, "Index: ids differ after reload")
        say("api", family="Index_hnsw", n_first=n0, wave=len(data) - n0,
            build_seconds=build_s, insert_seconds=insert_s,
            recall_at_10_inserted=rec, bar=0.90,
            self_first_inserted=self_first, rows_identical_after_reload=True)

    launches = {fn.__name__: fn.launches for fn in kernels}
    say("api", launches=json.dumps(launches))
    for name in ("exact_topk_sweep", "int8_sweep_topk", "int8_packed_topk",
                 "int8_bucket_topk", "hop_score"):
        check(launches[name] > 0, f"{name} was not launched on the API path")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the probe path
# ---------------------------------------------------------------------------

def probe_path(torch, data, records, floor_ms):
    """The probe scripts' path at full width: each floor once at the
    probes' shapes, then partitioned HNSW (r4e, r5c) and IVF-HNSW (r5c)
    through the ported harness, and a save / load of each. The floors and
    scan kernels were timed in phase 3; their times are printed here side
    by side, so that a scan kernel's time less its floor is its
    epilogue."""
    import tempfile

    import hnsw_tpu_torch as ht
    from hnsw_tpu_torch.bench import (measure_build, run_recall_benchmark,
                                      run_search_benchmark)
    from hnsw_tpu_torch.bench.kernels import floor_calls, probe_operands
    from hnsw_tpu_torch.models import FlatIndex
    from hnsw_tpu_torch.ops import hop, probes, scan

    kernels = (hop.hop_score, hop.hop_score_int8, scan.bucket_topk,
               scan.int8_bucket_topk, scan.exact_topk_sweep,
               scan.int8_sweep_topk, scan.int8_packed_topk, probes.mm_only,
               probes.mm_only_nt, probes.mm_only_kmajor, probes.matmul_only,
               probes.matmul_min)
    x = probe_operands(data)
    corpus = x["corpus"]
    torch.cuda.synchronize()

    for fn in kernels:
        fn.launches = 0
    # (a) the floors at the probes' shapes, beside the kernels they bound
    for label, call in floor_calls(x).items():
        out = call()
        torch.cuda.synchronize()
        check(tuple(out.shape) == (call.args[0].shape[0], 128) and
              bool(torch.isfinite(out.float()).all()),
              f"{label}: output of shape {tuple(out.shape)} or not finite")
        say("probe", stage="floor", what=label, ms=floor_ms[label])
    bf16_floor = floor_ms["mm_only_b4096_n31744"]
    int8_floor = floor_ms["matmul_min_b4096_nt2048"]
    for name, floor in (("bucket_topk", bf16_floor),
                        ("exact_topk_sweep", bf16_floor),
                        ("int8_bucket_topk", int8_floor),
                        ("int8_sweep_topk", int8_floor),
                        ("int8_packed_topk", int8_floor)):
        ms = records[name]["ms"]
        say("probe", stage="epilogue", kernel=f"{name} B=4096",
            kernel_ms=ms, floor_ms=floor, epilogue_ms=ms - floor)
    del x

    # (b) the families, measured with the ported harness
    exact = FlatIndex(corpus)
    q = data[:1024]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fam, kw, modes, bars in (
                ("partitioned_hnsw", dict(num_partitions=8),
                 ("balanced", "accurate"), {"accurate": 0.95}),
                ("ivf_hnsw", dict(num_partitions=32),
                 ("balanced", "precise"), {"balanced": 0.90})):
            idx, build_s = measure_build(
                lambda: ht.build_index(corpus, fam, **kw))
            say("probe", stage="build", family=fam, **kw,
                build_seconds=build_s)
            # the hop width c = expand * M0, a width no earlier phase ran
            width = idx.expand * (idx.m0 if fam == "partitioned_hnsw"
                                  else idx.adj0.shape[1])
            check(width == 256, f"{fam}: hop width {width}")
            for mode in modes:
                before = hop.hop_score.launches
                d, r = idx.search_batch(q, K, mode)
                check(hop.hop_score.launches > before,
                      f"{fam} {mode}: hop_score was not launched")
                check(bool((r >= 0).all()), f"{fam} {mode}: row -1")
                check(bool(torch.isfinite(d).all()),
                      f"{fam} {mode}: non-finite distances")
                rec = run_recall_benchmark(idx, data, k=K, mode=mode,
                                           num_queries=1024,
                                           exact_index=exact)["recall_at_k"]
                perf = run_search_benchmark(idx, q, k=K, mode=mode,
                                            batch_size=1024, warmup=1,
                                            iters=3, single_query_iters=0)
                results[(fam, mode)] = rec
                say("probe", stage="search", family=fam, mode=mode,
                    batch=1024, hop_width=width, recall_at_10=rec,
                    bar=bars.get(mode), qps_batched=perf["qps_batched"],
                    qps_device=perf["qps_device"],
                    batch_latency_ms=perf["batch_latency_ms"])
                if mode in bars:
                    check(rec >= bars[mode],
                          f"{fam} {mode}: recall {rec} < {bars[mode]}")
            rows = idx.search_batch(q, K, modes[-1])[1]
            path = ht.save_index(idx, f"{tmp}/{fam}", format="dir")
            back = ht.load_index(path)
            check(type(back) is type(idx) and
                  _rows_equal(torch, back.search_batch(q, K, modes[-1])[1],
                              rows), f"{fam}: rows differ after reload")
            say("probe", stage="persist", family=fam, format="dir",
                rows_identical=True)
            del idx, back
            torch.cuda.empty_cache()

    launches = {fn.__name__: fn.launches for fn in kernels}
    say("probe", launches=json.dumps(launches))
    for name in ("hop_score", "mm_only", "mm_only_nt", "mm_only_kmajor",
                 "matmul_only", "matmul_min"):
        check(launches[name] > 0, f"{name} was not launched on the probe path")
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
    check_sweep_kernels(torch, data, records)
    check_packed_kernel(torch, data, records)
    floor_ms = check_probe_kernels(torch, data, records)
    torch.cuda.empty_cache()

    launches = main_path(torch, data)
    torch.cuda.empty_cache()
    api_launches = api_path(torch, data)
    torch.cuda.empty_cache()
    probe_launches = probe_path(torch, data, records, floor_ms)
    out = []
    for name in KERNELS:
        rec = records[name]
        rec["launches"] = (launches.get(name, 0) + api_launches.get(name, 0)
                           + probe_launches[name])
        check(rec["launches"] > 0, f"{name} was not launched in phases 4-6")
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

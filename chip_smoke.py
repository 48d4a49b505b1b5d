#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (hnsw_tpu_torch) end to end on one card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build the kernels of hnsw_tpu_torch/csrc with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (hop_score at its three hops: phase 4's, hop
     width 256, and phase 8's 128-dim pack; hop_gather_score, G1, at an f32
     euclidean hop body of 1,024 x 128 slots over 60,000 x 896 rows and at
     the re-rank of 1,024 x 40 over 31,173 x 768, f32 and bf16 rows, each
     metric), and time kernel, plain version
     and a PyTorch yardstick that the port never calls (the hop kernels
     also on rotated operands past the L2, with the wrapper's host
     microseconds and the bf16 kernel's shared memory per block);
  4. the main path at full width: a 31,173 x 768 embedding-like corpus
     (cosine), the exact f32 flat index as ground truth, the bf16 and int8
     flat scans, the HNSW build (M=16) and HNSW serving with the bf16 and
     the int8 neighbour pack;
  4b. the search as one device program (device_loop_path), on phase 4's
     graph: the descent kernel (greedy_descent, D1) against its plain
     version from the graph's entry for 1,024 queries (bf16 shadow, cosine;
     f32 corpus, euclidean) and 32 (bf16, cosine): endpoints identical >=
     0.999, the steps a query takes (mean, p99, max), the latency floor
     (the longest walk times the recorded L2 round trip), one call and
     back to back, bound, yardstick, and the ptxas registers, spills and
     shared memory of the instantiation run; the expand kernel
     (hop_expand, E1) against its plain version on the inputs of every body
     of a B=1,024 search (bit for bit), and body 10 timed: one call, back
     to back, and alone in a CUDA graph, beside the plain version, the byte
     bound and the latency floor; the merge kernel (hop_merge, M1) against
     its plain version on the inputs of every update of the same search
     (the one before the loop and every body's), and body 10 timed: one
     call, back to back, alone in a CUDA graph and as a node of a graph of
     every body's call, beside the plain version, the byte bound and the
     latency floor; HNSWIndex's search replayed
     from its captured CUDA graph against the eager sync-free search (bf16
     and int8 packs, sampled and hierarchy entries, B=1,024 and 32; rows
     and hop counts identical, phase 4's bars at balanced B=1,024),
     IVF-HNSW and the entry() twin captured and replayed against their
     eager runs, each
     with the device's idle share, and hops against max_hops;
  5. the API path at full width (hnsw_tpu_torch.build_index, save_index,
     load_index, Index): flat indexes with scan_kernel "sweep" (bf16, int8)
     and "packed" (int8), the packed DOT guard on an unnormalized corpus,
     save / load in .npz and .idx, and a stateful HNSW index of 30,149 rows
     grown by one wave insert of 1,024;
  6. the probe path at full width (the twin of scripts/_probe_r4e.py, r4f,
     r5a and r5c): the four matmul floors, all on the wgmma mainloop, run at
     the probes' shapes; their phase-3 times are printed beside those of
     the scan kernels, each against the floor of its type and with the loop
     it runs, and as microseconds per 128-byte chunk per SM for every
     kernel on the wgmma mainloop; then partitioned HNSW (8
     partitions) and IVF-HNSW (32 clusters) built, searched at B=1024
     through the hop_score kernel at hop width 256, measured with the
     ported bench harness (recall@10 against the exact flat index, QPS,
     build seconds), and saved and loaded with identical rows;
  7. the four families ported last at full width, on phase 4's corpus and
     1,024 of its rows as queries, with bench.py's settings: IVF-FLAT (128
     partitions, spill), Lightning ("smart"), PCAF and LSH (defaults), each
     built, searched at its modes against its recall@10 bar, measured with
     the ported harness (qps_device at B=1024), and saved and loaded in
     .npz and .idx with identical rows. These families run no hand-written
     kernel: phase 7 launches none of the hand-written kernels, and checks
     that it did not;
  8. the large-N path at full width (large_path): a 500,000 x 768
     embedding-like corpus (bench.py's scale-sweep recipe, seed 7), the
     exact f32 flat index as ground truth for 1,024 of its rows, the HNSW
     build through the bucketed builder with bench.py's settings for that
     size (M=16, one layer, pack_dim=128, 4 probes, 2 refine rounds; the
     seconds of each stage, the builder's plan and the peak memory
     printed), serving at B=1,024 in four modes (recall@10, bar 0.95 at
     accurate; qps_device from the harness), and hop_score held against its
     plain version on the 128-dim pack and timed there at B=1,024 on the
     rows the searches returned; then the builder on the card
     against the CPU at 8,192 x 768, and phase 4's HNSW index served with
     the "sort", "bitonic" and "approx" beam merges;
  9. the multi-device layer and the tools (parallel_path), on phase 4's
     corpus and 1,024 of its rows as queries, each sharded call on the card
     as a mesh of one (make_mesh()) and on a virtual mesh of four cuda:0
     entries: ShardedFlatIndex against the exact f32 index (identical rows,
     distances within 1e-5), sharded_lloyd_step of 128 centroids against
     ops/kmeans.lloyd (1e-4, identical assignments), ShardedIVFFlat over
     bench.py's IVF-FLAT against its unsharded masked scan (identical rows,
     recall@10 >= 0.95 at accurate), build_partitioned_hnsw_sharded (8
     partitions, M=16) on the virtual mesh searched through
     ShardedPartitionedHNSW at precise (recall@10 >= 0.95, the same rows on
     both meshes) and through its single-device search (hop_score),
     dryrun_multichip on each mesh; then `bench.cli quick 1000`, a
     SearchShell over a 2,000-row JSON corpus and load_json_corpus of it
     through the native parser. The virtual mesh's shards share one card
     and one stream, so its times say nothing of a speed-up on several
     cards.
Phase 3 prints each kernel's ptxas registers and spill bytes on its [kernel]
lines. Phases 4, 4b, 5, 6, 8 and 9 each zero the launch counts just before
and read them just after; each must have run its kernels, and all
fifteen of KERNELS together. A search replayed from a CUDA graph counts the launches the graph
holds (utils/graphs.py).
Then one
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
           "mm_only", "mm_only_kmajor", "matmul_only", "matmul_min",
           "greedy_descent", "hop_expand", "hop_merge", "hop_gather_score")
K = 10
REPS = 5   # timed batches per family on the main path
ENTRY_SAMPLE = 2048   # HNSW sampled-entry rows for the serving bars
# phase 8: bench.py's scale-sweep corpus (make_corpus, seed 7) at 500,000
# rows and its HNSW settings for 150,000 < n <= 600,000 (bench.py:446-460)
LARGE_ROWS, LARGE_SEED = 500_000, 7
LARGE_BUILD = dict(M=16, hierarchy=False, pack_dim=128,
                   large_probe_clusters=4)


# the ptxas entry of each kernel: its source and a piece of its mangled name
# (<length><name> and the template arguments; for hop_score the
# instantiation of three chunks a lane, which the main path's D = 768 runs,
# for hop_score_int8 that of eight lanes a row, which glove's D = 128 runs,
# and for greedy_descent the bf16 cosine one of three chunks a lane)
KERNEL_ENTRIES = {
    "hop_score": ("hop.cu", "20hop_bf16_ring_kernelILi3E"),
    "hop_score_int8": ("hop.cu", "15hop_int8_kernelILi8ELi1ELi16EE"),
    "bucket_topk": ("scan.cu", "24bucket_bank_wgmma_kernelILb0E"),
    "int8_bucket_topk": ("scan.cu", "24bucket_bank_wgmma_kernelILb1E"),
    "exact_topk_sweep": ("sweep.cu", "18sweep_wgmma_kernelILb0E"),
    "int8_sweep_topk": ("sweep.cu", "18sweep_wgmma_kernelILb1E"),
    "int8_packed_topk": ("scan.cu", "24packed_bank_wgmma_kernel"),
    "mm_only": ("probes.cu", "13colsum_kernelILb0E"),
    "mm_only_nt": ("probes.cu", "13colsum_kernelILb0E"),
    "mm_only_kmajor": ("probes.cu", "13colsum_kernelILb1E"),
    "matmul_only": ("probes.cu", "16last_tile_kernelILb0E"),
    "matmul_min": ("probes.cu", "16last_tile_kernelILb1E"),
    "greedy_descent": ("descent.cu",
                       "20descent_block_kernelI13__nv_bfloat16Li0ELi3E"),
    "hop_expand": ("expand.cu", "17hop_expand_kernel"),
    "hop_merge": ("merge.cu", "16hop_merge_kernel"),
    # f32 rows, euclidean, eight chunks a lane: fmnist's hop body
    "hop_gather_score": ("gather.cu", "19gather_score_kernelIfLi1ELi8E"),
}


METRIC_CODES = {"cosine": 0, "euclidean": 1, "dot": 2}


# hop_score_int8's instantiation at each hop shape it is timed at: <lanes a
# row, units a lane, bytes a unit>
HOP_INT8_PIECES = {"a": "15hop_int8_kernelILi32ELi3ELi8EE",
                   "c": "15hop_int8_kernelILi8ELi1ELi16EE"}


def ptxas_fields(name: str, metric: str = None, piece: str = None) -> dict:
    """The kernel's registers and spill bytes from this run's ptxas report
    (the largest over its template instantiations, or, given a metric, of
    the instantiation of that metric: its second template argument; given
    a piece, of the instantiations it names). The wgmma kernels' registers
    are ptxas's count at 384 threads; setmaxnreg then gives each consumer
    warpgroup 232."""
    from hnsw_tpu_torch.ops import _cuda
    src, entry = KERNEL_ENTRIES[name]
    piece = piece or entry
    if metric is not None:
        piece += f"Li{METRIC_CODES[metric]}E"
    found = [v for k, v in _cuda.kernel_resources(
        _cuda.BUILD_LOG.get(src, "")).items() if piece in k]
    if not found:
        return dict(registers="not built in this run",
                    spill_bytes="not built in this run")
    return dict(registers=max(r for r, _ in found),
                spill_bytes=max(s for _, s in found))


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


def chunk_us(ms: float, b: int, rows: int, row_bytes: int, sms: int) -> float:
    """Microseconds per 128-byte chunk per SM of a wgmma.cuh kernel: its time
    over the chunks each SM walks (64-query blocks x 128-row tiles of the
    `rows` it walks x chunks per row, over the SMs)."""
    return ms * 1e3 / (-(-b // 64) * (rows // 128) * (row_bytes // 128) / sms)


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
    """B1 at the main path's three hops (bench/kernels.py, HOP_SHAPES: (a)
    phase 4's hop, (b) hop width 256, (c) the 500,000-row 128-dim pack) and
    B2 at (a) and at (c), glove's hop (its narrow plan: B2's
    narrow_launches steps once a call there): each held against its plain
    version, then timed as one call and 20 back to back, on one (queries,
    sel) draw and cycling through HOP_ROTATIONS draws (past the L2), with
    the wrapper's host microseconds per call. The records hold (a)."""
    from hnsw_tpu_torch.bench.kernels import (HOP_ROTATIONS, HOP_SHAPES,
                                              hop_bytes, hop_library,
                                              hop_operands, hop_readings)
    from hnsw_tpu_torch.ops import hop

    pack = None
    for name, key in (("hop_score", "a"), ("hop_score_int8", "a"),
                      ("hop_score", "b"), ("hop_score", "c"),
                      ("hop_score_int8", "c")):
        shape = HOP_SHAPES[key]
        int8 = name == "hop_score_int8"
        if pack is not None and pack.shape != (
                shape["n_pad"], shape["m0"], shape["d"]):
            pack = None
            torch.cuda.empty_cache()
        x = hop_operands(SEED, shape=shape, pack=pack, codes=int8,
                         rotations=HOP_ROTATIONS)
        pack = x["pack"]
        tensor = x["codes"] if int8 else pack
        fn = hop.hop_score_int8 if int8 else hop.hop_score
        plain = hop.hop_score_int8_plain if int8 else hop.hop_score_plain
        queries, sel = x["queries"], x["sel"]
        narrow = hop.hop_score_int8.narrow_launches
        got = fn(tensor, queries, sel)
        want = plain(tensor, queries, sel)
        torch.cuda.synchronize()
        check(hop.hop_score_int8.narrow_launches - narrow
              == (int8 and shape["d"] <= 256),
              f"{name} ({key}): narrow_launches stepped "
              f"{hop.hop_score_int8.narrow_launches - narrow} times")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        # f32 sums of D products taken in another order: 1e-4 of the largest
        # magnitude (csq for bf16 is checked the same way)
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        for err, w in zip(errs, want):
            check(err <= 1e-4 * float(w.abs().max()),
                  f"{name} ({key}) disagrees with its plain version: {errs}")
        del got, want
        outs = 1 if int8 else 2
        t = hop_readings(fn, tensor, x["draws"], outs)
        plain_ms = time_ms(lambda: plain(tensor, queries, sel), reps=5)
        lib_ms = time_ms(hop_library(tensor, queries, sel), reps=5)
        bms, by = bound(hop_bytes(tensor, queries, sel, outs),
                        2 * outs * sel.numel() * shape["m0"] * shape["d"],
                        BF16_OPS_S)
        ring = {} if int8 else dict(smem_bytes_per_block=hop.RING_SMEM_BYTES)
        say("kernel", name=name, shape=f"({key}) B={shape['b']},E={shape['e']},"
            f"M0={shape['m0']},D={shape['d']},N_pad={shape['n_pad']}",
            max_abs_err=max(errs), tol="1e-4*max|plain|",
            kernel_ms=t["ms"], back_to_back_ms=t["back_to_back_ms"],
            rotated_ms=t["rotated_ms"],
            rotated_back_to_back_ms=t["rotated_back_to_back_ms"],
            host_us=t["host_us"], plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bms, bound_by=by,
            rotated_bound_ms=t["rotated_bound_ms"],
            **ptxas_fields(name, piece=HOP_INT8_PIECES[key] if int8
                           else None), **ring)
        if key == "a":
            records[name] = dict(
                name=name, route="cuda", source="hnsw_tpu_torch/csrc/hop.cu",
                replaces=("hnsw_tpu/ops/pallas_hop.py:276" if int8
                          else "hnsw_tpu/ops/pallas_hop.py:152"),
                max_abs_err=max(errs), ms=t["ms"], plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del x, tensor, queries, sel
    del pack
    torch.cuda.empty_cache()


def check_gather_kernel(torch, records):
    """G1 against its plain version: at an f32 euclidean hop body (B=1,024,
    C=128, 60,000 x 896 rows; fmnist60k.bulk's shares: 16.9% of the queries
    stopped, with no valid slot, and 17.3% of the others' slots not valid,
    0.687 valid in all; rows clamped to 0 there) and at the re-rank
    (B=1,024, C=40, 31,173 x 768), each with f32 and bf16 rows and each
    metric: BIG exactly where not valid, distances within 3e-5 |q| |v| (f32
    sums of the same products in other orders; euclidean as d^2). Then each
    shape's f32 euclidean call timed: one call, back to back, as a node of
    a graph of eight calls on eight draws of rows (as the search's bodies
    pay), the plain version, and the PyTorch gather + einsum alone, beside
    the byte bound of the valid rows read once. The records hold the
    hop body's."""
    from hnsw_tpu_torch.bench.kernels import burst_ms
    from hnsw_tpu_torch.ops import gather

    kernel, plain = gather.hop_gather_score, gather.hop_gather_score_plain
    for label, (b, c, n, d) in (("hop body", (1024, 128, 60000, 896)),
                                ("re-rank", (1024, 40, 31173, 768))):
        g = torch.Generator(device="cpu").manual_seed(SEED + d)
        vectors = torch.nn.functional.normalize(
            torch.randn(n, d, generator=g), dim=1).cuda()
        v_sq = (vectors * vectors).sum(1)
        queries = (vectors[torch.randint(0, n, (b,), generator=g).cuda()]
                   + 0.05 * torch.randn(b, d, generator=g).cuda())
        q_sq = (queries * queries).sum(1, keepdim=True)
        draws = []
        for _ in range(8):
            rows = torch.randint(0, n, (b, c), generator=g, dtype=torch.int32)
            valid = torch.rand(b, c, generator=g) >= 0.173
            valid[torch.rand(b, generator=g) < 0.169] = False
            draws.append((torch.where(valid, rows, 0).cuda(), valid.cuda()))
        rows, valid = draws[0]
        c_sq = v_sq[rows.long()]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            vecs = vectors.to(dtype)
            tol = 3e-5 * torch.sqrt(q_sq * c_sq) * (
                1.01 if dtype == torch.bfloat16 else 1.0)
            for metric in METRIC_CODES:
                got = kernel(queries, rows, vecs, v_sq, metric, valid, q_sq)
                want = plain(queries, rows, vecs, v_sq, metric, valid, q_sq)
                torch.cuda.synchronize()
                check(torch.equal(got == 1e30, ~valid),
                      f"hop_gather_score ({label}, {dtype}, {metric}): BIG "
                      "not exactly where not valid")
                gv, wv = got[valid].double(), want[valid].double()
                t = tol[valid].double()
                if metric == "euclidean":
                    err = (gv * gv - wv * wv).abs()
                    bar = 2 * t + 1e-6 * (q_sq + c_sq)[valid].double()
                elif metric == "cosine":
                    err = (gv - wv).abs()
                    bar = t / torch.sqrt((q_sq * c_sq)[valid].double()) + 1e-6
                else:
                    err, bar = (gv - wv).abs(), t + 1e-6
                check(bool((err <= bar).all()),
                      f"hop_gather_score ({label}, {dtype}, {metric}) "
                      f"disagrees with its plain version: "
                      f"{float((err - bar).max())} past its bar")
                errs[f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_"
                     f"{metric}"] = float((gv - wv).abs().max())
                del got, want
        launches = kernel.launches
        args = (queries, rows, vectors, v_sq, "euclidean", valid, q_sq)
        ms = time_ms(lambda: kernel(*args))
        b2b_ms = burst_ms(lambda: kernel(*args))
        node_ms = graph_ms(torch, lambda: [
            kernel(queries, r, vectors, v_sq, "euclidean", v, q_sq)
            for r, v in draws], len(draws))
        plain_ms = time_ms(lambda: plain(*args), reps=5)
        library_ms = time_ms(lambda: torch.einsum(
            "bd,bcd->bc", queries, vectors[rows]), reps=5)
        kernel.launches = launches
        kept = int(valid.sum())
        # the valid rows and their norms read once; ids and flags read, the
        # queries and their norms read, the distances written
        nbytes = kept * (d * 4 + 4) + b * c * (4 + 1 + 4) + b * (d * 4 + 4)
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        say("kernel", name="hop_gather_score", shape=f"({label}) B={b},C={c},"
            f"D={d},N={n}", valid_share=kept / (b * c),
            max_abs_err=json.dumps(errs), tol="3e-5*|q||v| (d^2: twice)",
            kernel_ms=ms, back_to_back_ms=b2b_ms, graph_node_ms=node_ms,
            plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
            bound_ms=bytes_ms, bound_by="bytes",
            bytes_per_s_node=nbytes / (node_ms * 1e-3),
            shared_memory_bytes=gather.shared_bytes(d, 4),
            **ptxas_fields("hop_gather_score"))
        if label == "hop body":
            records["hop_gather_score"] = dict(
                name="hop_gather_score", route="cuda",
                source="hnsw_tpu_torch/csrc/gather.cu",
                replaces="hnsw_tpu/models/hnsw/search.py:109-120, 356",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=bytes_ms, bound_by="bytes", library_ms=library_ms)
        del vectors, v_sq, queries, draws, rows, valid, args
        torch.cuda.empty_cache()


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
                      row_agreement_bar=0.999, **ptxas_fields("bucket_topk"))
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

    n_pad = 32768
    for metric in ("cosine", "euclidean", "dot"):
        corpus = Corpus.from_array(data, metric=metric)
        v8, vscale = quantize_rows(corpus.vectors)
        v8 = torch.nn.functional.pad(v8, (0, 0, 0, n_pad - corpus.n_pad))
        vscale = torch.nn.functional.pad(vscale, (0, n_pad - corpus.n_pad))
        vsq = torch.nn.functional.pad(corpus.sq_norms,
                                      (0, n_pad - corpus.n_pad))
        q8, qscale = quantize_rows(corpus.pad_queries(data[:b]))
        qmeta = torch.stack([qscale, torch.zeros_like(qscale)], dim=1)
        vkey = scan.int8_vkey(vscale, vsq, metric)
        kd, kr = scan.int8_bucket_bank(v8, vkey, vscale, q8, qscale, corpus.n,
                                       metric=metric)
        pd, pr = scan.int8_bucket_bank_plain(v8, vkey, vscale, q8, qscale,
                                             corpus.n, metric=metric)
        torch.cuda.synchronize()
        live = (pd < 1e29) & (kd < 1e29)
        err = float((kd - pd).abs()[live].max())
        # int32 dots are exact on both sides, and the key's f32 operations
        # are the plain version's
        check(err <= 1e-3, f"int8_bucket_topk {metric}: key error {err}")
        pk = torch.sort(pd, dim=-1, stable=True)
        for k in (16, 10):
            dk, rk = scan.int8_bucket_topk(v8, vscale, vsq, q8, qmeta,
                                           corpus.n, k=k, metric=metric,
                                           bt=256, nt=2048)
            prow = torch.gather(pr, -1, pk.indices[:, :k])
            agree = float((rk == prow).float().mean())
            check(agree >= 0.999,
                  f"int8_bucket_topk {metric} k={k}: agreement {agree}")
            say("kernel", name="int8_bucket_topk", metric=metric,
                shape=f"B={b},N_pad={n_pad},D={d},k={k}", max_abs_err=err,
                tol=1e-3, row_agreement=agree, row_agreement_bar=0.999,
                **ptxas_fields("int8_bucket_topk"))
        if metric != "cosine":
            records["int8_bucket_topk"]["max_abs_err"] = max(
                records["int8_bucket_topk"]["max_abs_err"], err)
            continue
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
            library_ms=lib_ms, bound_ms=bms, bound_by=by,
            **ptxas_fields("int8_bucket_topk"))
        records["int8_bucket_topk"] = dict(
            name="int8_bucket_topk", route="cuda",
            source="hnsw_tpu_torch/csrc/scan.cu",
            replaces="hnsw_tpu/ops/pallas_scan.py:395",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        del v8t
    del v8


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
                          row_agreement_bar=0.999,
                          **ptxas_fields(name, metric))
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
                tol=0, row_agreement=agree, row_agreement_bar=0.999,
                **ptxas_fields("int8_packed_topk"))
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
                bound_by=by, **ptxas_fields("int8_packed_topk"))
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
            library_ms=lib_ms, library=lib_what, bound_ms=bms, bound_by=by,
            **ptxas_fields(call.kernel.__name__))
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
    return launches, served


# ---------------------------------------------------------------------------
# phase 4b: the search as one device program
# ---------------------------------------------------------------------------

def descent_bytes(torch, adj_upper, vectors, visits, b: int) -> int:
    """Bytes the walk must read once: the adjacency rows of the distinct
    (layer, row) neighbourhoods its steps scored, the distinct neighbour
    rows and their norms, and the queries, norms and walk states in and
    out."""
    n_pad, m = adj_upper.shape[1], adj_upper.shape[2]
    keys = torch.unique(torch.cat([l * n_pad + rows.long()
                                   for l, _, rows in visits]))
    nb = adj_upper[keys // n_pad, keys % n_pad]
    rows = torch.unique(nb[nb >= 0])
    d = vectors.shape[1]
    return (keys.numel() * m * 4 + rows.numel() * (d * vectors.element_size()
                                                   + 4)
            + b * (d * 4 + 4 + 8 + 8))


# one dependent L2 round trip on the H100 (NVIDIA H100 80GB HBM3, 700 W), in
# microseconds: one warp chasing the lowest upper layer of this graph
# (`python3 scripts/descent_ablate.py walk`; PERF.md, section 6)
L2_ROUND_TRIP_US = 0.1668


def descent_ptxas(metric: str, vectors) -> dict:
    """Registers and spill bytes of the descent instantiation that phase
    4b's walks run (its template arguments: the value type, the metric
    code, the chunks a lane holds: at D = 768 a row has 32 lanes, so three
    of bf16, six of f32)."""
    from hnsw_tpu_torch.ops import _cuda
    nc = vectors.shape[1] * vectors.element_size() // 16 // 32
    value = "13__nv_bfloat16" if vectors.element_size() == 2 else "f"
    piece = (f"20descent_block_kernelI{value}Li{METRIC_CODES[metric]}E"
             f"Li{nc}E")
    found = [v for k, v in _cuda.kernel_resources(
        _cuda.BUILD_LOG.get("descent.cu", "")).items() if piece in k]
    if not found:
        return dict(registers="not built in this run",
                    spill_bytes="not built in this run")
    return dict(registers=found[0][0], spill_bytes=found[0][1])


def check_descent_kernel(torch, index, q, records):
    """D1 against its plain version on phase 4's graph at full width: every
    query walks from the graph's entry, with the bf16 shadow (cosine, the
    main path's) at B=1,024 and B=32, and with the f32 corpus (euclidean)
    at B=1,024; the steps a query takes (from the plain walk's visits), the
    latency floor (the longest walk's steps times the recorded L2 round
    trip), one call and back to back. Launches made here are not
    counted."""
    from hnsw_tpu_torch.bench.kernels import burst_ms
    from hnsw_tpu_torch.ops import descent
    from hnsw_tpu_torch.ops.distance import shadow_score

    g, corpus = index.graph, index.corpus
    upper = g.adj_upper
    for metric, dtype, b in (("cosine", torch.bfloat16, 1024),
                             ("euclidean", torch.float32, 1024),
                             ("cosine", torch.bfloat16, 32)):
        vectors = corpus.vectors.to(dtype)
        qb = q[:b].contiguous()
        q_sq = (qb * qb).sum(-1)
        launches = descent.greedy_descent.launches
        cur = torch.full((b,), g.entry, dtype=torch.int32, device=q.device)
        d0 = shadow_score(qb, cur[:, None].long(), vectors, corpus.sq_norms,
                          metric, (cur >= 0)[:, None])[:, 0].contiguous()
        args = (qb, q_sq, cur, d0, upper, vectors, corpus.sq_norms)
        kc, kd = descent.greedy_descent(*args, metric)
        visits = []
        pc, pd = descent.greedy_descent_plain(*args, metric, visits=visits)
        torch.cuda.synchronize()
        same = kc == pc
        agree = float(same.float().mean())
        err = float((kd - pd)[same].abs().max())
        # f32 sums in another order; euclidean is held in d^2 / 2 max|v|^2,
        # where that error is additive (the walks end at the query's own
        # row, where sqrt magnifies it), as the tests hold it
        tol, scaled = 1e-4 * max(float(pd.abs().max()), 1.0), err
        if metric == "euclidean":
            scale = 2 * float(corpus.sq_norms.max())
            scaled = float((kd ** 2 - pd ** 2)[same].abs().max()) / scale
            tol = 1e-5
        label = f"greedy_descent {metric} B={b}"
        check(agree >= 0.999, f"{label}: endpoints agree {agree} < 0.999")
        check(scaled <= tol, f"{label}: distance error {scaled} > {tol}")
        check(bool(torch.isfinite(kd).all()) and bool((kc >= 0).all()),
              f"{label}: non-finite or -1")
        steps = sum(int(rows.numel()) for _, _, rows in visits)
        per_query = torch.bincount(torch.cat([who for _, who, _ in visits]),
                                   minlength=b).float()
        longest = int(per_query.max())
        ms = time_ms(lambda: descent.greedy_descent(*args, metric))
        b2b_ms = burst_ms(lambda: descent.greedy_descent(*args, metric))
        plain_ms = time_ms(lambda: descent.greedy_descent_plain(*args, metric),
                           reps=3, warmup=1)
        # the yardstick: one gather + einsum of the first step, in the
        # kernel's dtype, times the batch steps the plain loop took
        nb = upper[-1][cur.long()].clamp(min=0)
        qc = qb.to(vectors.dtype)
        lib_ms = time_ms(lambda: torch.einsum(
            "bd,bmd->bm", qc, vectors[nb])) * len(visits)
        bms, by = bound(descent_bytes(torch, upper, vectors, visits, b),
                        2 * steps * upper.shape[2] * vectors.shape[1],
                        BF16_OPS_S)
        descent.greedy_descent.launches = launches
        say("device_loop", stage="descent", metric=metric,
            dtype=str(vectors.dtype).split(".")[-1],
            shape=f"B={b},L={upper.shape[0]},M={upper.shape[2]},"
            f"D={vectors.shape[1]},N_pad={vectors.shape[0]}",
            endpoints_identical=agree, bar=0.999, max_abs_err=err,
            held_err=scaled, tol=tol,
            steps_per_query=steps / b,
            steps_p99=float(torch.sort(per_query).values[
                min(b - 1, int(0.99 * b))]),
            steps_max=longest, batch_steps=len(visits),
            round_trip_us=L2_ROUND_TRIP_US, round_trip_from="recorded",
            latency_floor_ms=longest * L2_ROUND_TRIP_US / 1e3,
            kernel_ms=ms, back_to_back_ms=b2b_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bms, bound_by=by,
            shared_memory_bytes=descent.shared_bytes(
                upper.shape[2], vectors.shape[1], vectors.element_size()),
            **descent_ptxas(metric, vectors))
        if metric == "cosine" and b == 1024:
            records["greedy_descent"] = dict(
                name="greedy_descent", route="cuda",
                source="hnsw_tpu_torch/csrc/descent.cu",
                replaces="hnsw_tpu/models/hnsw/search.py:123",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        del vectors, args


def graph_ms(torch, fn, nodes: int = 1) -> float:
    """Device ms of fn() captured alone in a CUDA graph, replayed back to
    back (after one eager run on a side stream), over the `nodes` calls of
    one kernel that fn makes."""
    from hnsw_tpu_torch.bench.kernels import burst_ms
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return burst_ms(g.replay) / nodes


def check_expand_kernel(torch, index, q, records):
    """E1 against its plain version at the Bible bulk shape: the inputs of
    every body of one search of phase 4's graph (B=1,024, E 4, M0 32, ef
    200, bf16 pack, sampled entries), recorded from the body's calls, each
    held bit for bit; then body 10's inputs timed: one call, back to back,
    and kernel and plain version each captured alone in a CUDA graph and
    replayed back to back (what a body of the captured search pays), beside
    the byte bound and the latency floor (a one-thread kernel, the tracer's
    stamp, back to back). Launches made here are not counted."""
    from hnsw_tpu_torch.bench.kernels import burst_ms
    from hnsw_tpu_torch.models import HNSWIndex
    from hnsw_tpu_torch.ops import expand
    from hnsw_tpu_torch.utils import tracing

    kernel, plain = expand.hop_expand, expand.hop_expand_plain
    launches = kernel.launches
    idx = HNSWIndex(index.corpus, index.graph, entry_sample=ENTRY_SAMPLE,
                    entry_mode="sample", pack_precision="bf16")
    bodies = []

    def recording(adj0, sel_ids, beam_ids):
        bodies.append((adj0, sel_ids.clone(), beam_ids.clone()))
        return kernel(adj0, sel_ids, beam_ids)

    recording.launches = 0
    expand.hop_expand = recording        # the search looks it up per call
    try:
        idx._search_fn(K, "balanced", None, False)[0](q)
    finally:
        expand.hop_expand = kernel
    torch.cuda.synchronize()
    for i, args in enumerate(bodies):
        got, want = kernel(*args), plain(*args)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"hop_expand body {i}: differs from the plain version")
    args = bodies[10]
    adj0, sel, beam = args
    b, e = sel.shape
    m0, ef = adj0.shape[1], beam.shape[1]

    ms = time_ms(lambda: kernel(*args))
    b2b_ms = burst_ms(lambda: kernel(*args))
    graph_kernel_ms = graph_ms(torch, lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    graph_plain_ms = graph_ms(torch, lambda: plain(*args))
    state = torch.zeros(2 + len(tracing.PHASES), dtype=torch.int64,
                        device=q.device)
    stamps = tracing.stamp.launches
    floor_ms = burst_ms(lambda: tracing.stamp(state, -1))
    tracing.stamp.launches = stamps
    kernel.launches = launches
    selected = int((sel >= 0).sum())
    nbytes = (b * e * 4 + selected * m0 * 4 + b * ef * 4
              + b * e * m0 * 5)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bms, by = max((bytes_ms, "bytes"), (floor_ms, "latency"))
    valid = plain(*args)[1]
    say("device_loop", stage="expand",
        shape=f"B={b},E={e},M0={m0},ef={ef},N_pad={adj0.shape[0]}",
        bodies_identical=len(bodies), body=10, selected_rows=selected,
        valid_share=float(valid.float().mean()),
        kernel_ms=ms, back_to_back_ms=b2b_ms, graph_ms=graph_kernel_ms,
        plain_ms=plain_ms, plain_graph_ms=graph_plain_ms,
        bytes=nbytes, bytes_bound_ms=bytes_ms, latency_floor_ms=floor_ms,
        bound_ms=bms, bound_by=by,
        shared_memory_bytes=expand.shared_bytes(e * m0, ef),
        **ptxas_fields("hop_expand"))
    records["hop_expand"] = dict(
        name="hop_expand", route="cuda",
        source="hnsw_tpu_torch/csrc/expand.cu",
        replaces="hnsw_tpu/models/hnsw/search.py:308-316",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)
    del idx, bodies, args


def check_merge_kernel(torch, index, q, records):
    """M1 against its plain version at the Bible bulk shape: the inputs of
    every update of one search of phase 4's graph (B=1,024, E 4, M0 32, ef
    200, bf16 pack, sampled entries: the select before the loop, with no
    candidates, then the merge and next select of each of the 62 bodies),
    recorded from the search's calls, each held bit for bit; then body 10's
    inputs timed: one call, back to back, alone in a CUDA graph, and as a
    node of a graph of every body's call (what a body of the captured
    search pays), the plain version likewise, beside the byte bound and the
    latency floor (the tracer's one-thread stamp, back to back and as a node
    of a graph of as many). Launches made here are not counted."""
    from hnsw_tpu_torch.bench.kernels import burst_ms
    from hnsw_tpu_torch.models import HNSWIndex
    from hnsw_tpu_torch.ops import merge
    from hnsw_tpu_torch.utils import tracing

    kernel, plain = merge.hop_merge, merge.hop_merge_plain
    launches = kernel.launches
    idx = HNSWIndex(index.corpus, index.graph, entry_sample=ENTRY_SAMPLE,
                    entry_mode="sample", pack_precision="bf16")
    calls = []

    def recording(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return kernel(*args)

    recording.launches = 0
    merge.hop_merge = recording          # the search looks it up per call
    try:
        idx._search_fn(K, "balanced", None, False)[0](q)
    finally:
        merge.hop_merge = kernel
    torch.cuda.synchronize()
    for i, args in enumerate(calls):
        got, want = kernel(*args), plain(*args)
        # distances as their bits; then ids, flags, sel_ids, active
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
              f"hop_merge call {i}: differs from the plain version")
    bodies = calls[1:]
    args = bodies[10]
    beam_d, cand_d, e = args[0], args[3], args[6]
    b, ef = beam_d.shape
    c = cand_d.shape[1]

    def every_body(fn):
        return lambda: [fn(*a) for a in bodies]

    ms = time_ms(lambda: kernel(*args))
    b2b_ms = burst_ms(lambda: kernel(*args))
    graph_kernel_ms = graph_ms(torch, lambda: kernel(*args))
    node_ms = graph_ms(torch, every_body(kernel), len(bodies))
    plain_ms = time_ms(lambda: plain(*args))
    graph_plain_ms = graph_ms(torch, lambda: plain(*args))
    plain_node_ms = graph_ms(torch, every_body(plain), len(bodies))
    state = torch.zeros(2 + len(tracing.PHASES), dtype=torch.int64,
                        device=q.device)
    stamps = tracing.stamp.launches
    floor_ms = burst_ms(lambda: tracing.stamp(state, -1))
    node_floor_ms = graph_ms(
        torch, lambda: [tracing.stamp(state, -1) for _ in bodies],
        len(bodies))
    tracing.stamp.launches = stamps
    kernel.launches = launches
    # read: beam (d, id, exp), candidates (d, id), active; written: the
    # beam, sel_ids, active
    nbytes = b * (ef * 9 + c * 8 + 1) + b * (ef * 9 + e * 4 + 1)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bms, by = max((bytes_ms, "bytes"), (node_floor_ms, "latency"))
    active = kernel(*args)[4]
    say("device_loop", stage="merge",
        shape=f"B={b},E={e},C={c},ef={ef}", calls_identical=len(calls),
        body=10, active_share=float(active.float().mean()),
        kernel_ms=ms, back_to_back_ms=b2b_ms, graph_ms=graph_kernel_ms,
        graph_node_ms=node_ms, plain_ms=plain_ms,
        plain_graph_ms=graph_plain_ms, plain_graph_node_ms=plain_node_ms,
        bytes=nbytes, bytes_bound_ms=bytes_ms, latency_floor_ms=floor_ms,
        latency_floor_node_ms=node_floor_ms, bound_ms=bms, bound_by=by,
        shared_memory_bytes=merge.shared_bytes(ef, c),
        **ptxas_fields("hop_merge"))
    records["hop_merge"] = dict(
        name="hop_merge", route="cuda",
        source="hnsw_tpu_torch/csrc/merge.cu",
        replaces="hnsw_tpu/models/hnsw/search.py:293-306, 358-359",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)
    del idx, calls, bodies, args


def hops_of(module, call):
    """Run call() with `module`'s hnsw_search_batch counting hops, and
    return the hop counts of its searches."""
    real, seen = module.hnsw_search_batch, []

    def counting(*args, **kwargs):
        d, r, hops = real(*args, debug_hops=True, **kwargs)
        seen.append(hops)
        return d, r

    module.hnsw_search_batch = counting
    try:
        call()
    finally:
        module.hnsw_search_batch = real
    return seen


def device_loop_path(torch, index, data, records):
    """Phase 4b on phase 4's graph: D1 against its plain version, then the
    HNSW search replayed from a captured CUDA graph against the eager
    sync-free search (bf16 and int8 packs, sampled and hierarchy entries,
    B=1,024 and 32), IVF-HNSW and the entry() twin captured and replayed,
    each with the device's idle share; hops against max_hops per mode and
    family. Launch counts zeroed just before the searches, read after."""
    import hnsw_tpu_torch as ht
    import hnsw_tpu_torch.models.ivf_hnsw as ivf_mod
    from hnsw_tpu_torch.config import IVF_HNSW_MODES, Mode, ef_for
    from hnsw_tpu_torch.entry import entry
    from hnsw_tpu_torch.models import FlatIndex, HNSWIndex
    from hnsw_tpu_torch.utils.graphs import CapturedCall

    corpus = index.corpus
    q1024 = corpus.pad_queries(data[:1024])
    _, truth = FlatIndex(corpus).search_batch(q1024, K)
    check_descent_kernel(torch, index, q1024, records)
    check_expand_kernel(torch, index, q1024, records)
    check_merge_kernel(torch, index, q1024, records)
    torch.cuda.empty_cache()

    kernels = all_kernels()
    for fn in kernels:
        fn.launches = 0
    for mode_name, pp in (("sample", "bf16"), ("sample", "int8"),
                          ("hierarchy", "bf16"), ("hierarchy", "int8")):
        idx = HNSWIndex(corpus, index.graph, entry_sample=ENTRY_SAMPLE,
                        entry_mode=mode_name, pack_precision=pp)
        for mode in ("turbo", "balanced"):
            for b in ((1024, 32) if mode == "balanced" else (1024,)):
                q = q1024[:b]
                run = idx._search_fn(K, mode, None, True)[0]
                ed, er, eh = run(q)
                d, r, hops = idx.search_batch(q, K, mode, debug_hops=True)
                d2, r2, hops2 = idx.search_batch(q, K, mode, debug_hops=True)
                label = f"hnsw_{pp}_pack {mode_name} {mode} B={b}"
                check(_rows_equal(torch, r, er) and _rows_equal(torch, r2, er)
                      and bool(torch.equal(d, ed)),
                      f"{label}: replay differs from the eager search")
                check(hops == hops2 == int(eh),
                      f"{label}: hops {hops} / {hops2} / {int(eh)}")
                check(bool((r >= 0).all()) and bool(torch.isfinite(d).all()),
                      f"{label}: row -1 or a non-finite distance")
                rec = recall(r, truth[:b])
                self_first = float((r[:, 0].cpu() == torch.arange(b)).float()
                                   .mean())
                ef = ef_for(mode, K)
                max_hops = ef // min(idx.expand, ef) + 12
                fields = dict(family=label, recall_at_10=rec,
                              self_first=self_first, hops=hops,
                              max_hops=max_hops, rows_identical_to_eager=True)
                if mode == "balanced":
                    run = idx._search_fn(K, mode, None, False)[0]
                    eager = device_share(torch, lambda: run(q))
                    replay = device_share(
                        torch, lambda: idx.search_batch(q, K, mode))
                    fields.update(
                        eager_unprofiled_ms=batch_ms(torch, lambda: run(q)),
                        replay_unprofiled_ms=batch_ms(
                            torch, lambda: idx.search_batch(q, K, mode)),
                        replay_event_ms=time_ms(
                            lambda: idx.search_batch(q, K, mode), reps=3),
                        **{f"eager_{k}": v for k, v in eager.items()},
                        **{f"replay_{k}": v for k, v in replay.items()})
                say("device_loop", stage="replay", **fields)
                if mode == "balanced" and b == 1024:
                    check(rec >= 0.95, f"{label}: recall {rec}")
                    # phase 4's self-first bar, where phase 4 holds it:
                    # from the graph's entry, the reference's walk misses
                    # the same queries (scripts/entry_sample_card.py, then
                    # scripts/entry_sample_reference.py; PERF.md)
                    if mode_name == "sample":
                        check(self_first >= 0.99,
                              f"{label}: self first {self_first}")
        del idx
        torch.cuda.empty_cache()

    # IVF-HNSW (multi-entry seeds, no descent) and the entry() twin, each
    # captured and replayed against its eager run
    ivf = ht.build_index(corpus, "ivf_hnsw", num_partitions=32)
    for mode in ("balanced", "precise"):
        hops = hops_of(ivf_mod, lambda: ivf.search_batch(q1024, K, mode))
        _, ef = IVF_HNSW_MODES[Mode.coerce(mode)]
        ef = max(ef, K)
        say("device_loop", stage="hops", family="ivf_hnsw", mode=mode,
            hops=hops[0], max_hops=2 * (ef // min(ivf.expand, ef)) + 16)
    ed, er = ivf.search_batch(q1024, K, "balanced")
    call = CapturedCall(lambda q: ivf.search_batch(q, K, "balanced"), q1024)
    d, r = call(q1024)
    check(_rows_equal(torch, r, er) and bool(torch.equal(d, ed)),
          "ivf_hnsw: replay differs from the eager search")
    say("device_loop", stage="replay", family="ivf_hnsw balanced B=1024",
        recall_at_10=recall(r, truth[:1024]), rows_identical_to_eager=True,
        eager_unprofiled_ms=batch_ms(
            torch, lambda: ivf.search_batch(q1024, K, "balanced")),
        replay_unprofiled_ms=batch_ms(torch, lambda: call(q1024)),
        replay_event_ms=time_ms(lambda: call(q1024), reps=3),
        **{f"replay_{k}": v for k, v in device_share(
            torch, lambda: call(q1024)).items()})
    del ivf, call
    torch.cuda.empty_cache()

    step, args = entry()
    ed, er = step(*args)
    call = CapturedCall(lambda q: step(*args[:5], q), args[5])
    d, r = call(args[5])
    check(_rows_equal(torch, r, er) and bool(torch.equal(d, ed)),
          "entry(): replay differs from the eager search")
    check(float((r[:, 0].cpu() == torch.arange(32)).float().mean()) >= 0.9,
          "entry(): queries do not find themselves")
    say("device_loop", stage="replay", family="entry() B=32",
        rows_identical_to_eager=True,
        eager_unprofiled_ms=batch_ms(torch, lambda: step(*args)),
        replay_unprofiled_ms=batch_ms(torch, lambda: call(args[5])),
        replay_event_ms=time_ms(lambda: call(args[5]), reps=3),
        **{f"replay_{k}": v for k, v in device_share(
            torch, lambda: call(args[5])).items()})

    launches = {fn.__name__: fn.launches for fn in kernels}
    say("device_loop", launches=json.dumps(launches))
    for name in ("greedy_descent", "hop_score", "hop_score_int8",
                 "hop_expand", "hop_merge"):
        check(launches[name] > 0, f"{name} was not launched in phase 4b")
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
    from hnsw_tpu_torch.ops import descent, hop, scan

    # the wave insert walks the upper layers with greedy_descent
    kernels = (hop.hop_score, hop.hop_score_int8, scan.bucket_topk,
               scan.int8_bucket_topk, scan.exact_topk_sweep,
               scan.int8_sweep_topk, scan.int8_packed_topk,
               descent.greedy_descent)
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
        # The inserted rows come back first about 0.81 of the time, as in
        # the reference: the JAX insert on the same graph and wave gives the
        # same graph and rows (scripts/wave_insert_card.py, then
        # scripts/wave_insert_reference.py). The bar is the JAX tests'
        # recall after an insert.
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
    by side, so that a scan kernel's time less its floor is what its
    epilogue costs beside the wgmma mainloop of the floors."""
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
    # (a) the floors at the probes' shapes, beside the kernels they bound,
    # with the time of one 128-byte chunk on an SM of each wgmma.cuh kernel
    # (a split column sum's and bucket_topk's include their merge)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, call in floor_calls(x).items():
        out = call()
        torch.cuda.synchronize()
        q, v = call.args
        check(tuple(out.shape) == (q.shape[0], 128) and
              bool(torch.isfinite(out.float()).all()),
              f"{label}: output of shape {tuple(out.shape)} or not finite")
        rows = v.shape[1 if "kmajor" in label else 0]
        rows -= rows % call.kwargs.get("nt", 128)
        row_bytes = q.shape[1] * q.element_size()
        say("probe", stage="floor", what=label, loop="wgmma.cuh",
            ms=floor_ms[label], us_per_chunk_per_sm=chunk_us(
                floor_ms[label], q.shape[0], rows, row_bytes, sms))
    for name, rows, row_bytes in (("bucket_topk", 31744, DIM * 2),
                                  ("exact_topk_sweep", 31744, DIM * 2),
                                  ("int8_bucket_topk", 32768, DIM),
                                  ("int8_sweep_topk", 32768, DIM),
                                  ("int8_packed_topk", 32768, DIM)):
        say("probe", stage="chunk", what=f"{name} B=4096", loop="wgmma.cuh",
            ms=records[name]["ms"], us_per_chunk_per_sm=chunk_us(
                records[name]["ms"], 4096, rows, row_bytes, sms))
    # Each scan kernel against the floor of its type, which runs the wgmma
    # mainloop (csrc/wgmma.cuh) with no epilogue at the same B and corpus;
    # every scan kernel runs that loop too, so the difference is its bank or
    # its running top-k.
    floors = {"bf16": ("mm_only B=4096 N=31744", "mm_only_b4096_n31744"),
              "int8": ("matmul_only nt=2048", "matmul_only_b4096_nt2048")}
    for name, kind, loop in (
            ("bucket_topk", "bf16", "wgmma.cuh"),
            ("exact_topk_sweep", "bf16", "wgmma.cuh"),
            ("int8_bucket_topk", "int8", "wgmma.cuh"),
            ("int8_sweep_topk", "int8", "wgmma.cuh"),
            ("int8_packed_topk", "int8", "wgmma.cuh")):
        ms = records[name]["ms"]
        floor_name, label = floors[kind]
        say("probe", stage="floor_gap", kernel=f"{name} B=4096", loop=loop,
            kernel_ms=ms, floor=floor_name, floor_ms=floor_ms[label],
            kernel_minus_floor_ms=ms - floor_ms[label])
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


# ---------------------------------------------------------------------------
# phase 7: the families ported last
# ---------------------------------------------------------------------------

# family, build options (bench.py's), searches (label, mode, options), the
# mode of the bar and its recall@10 bar
FAMILIES7 = (
    ("ivf_flat", dict(num_partitions=128, spill=1),
     (("balanced", "balanced", {}), ("accurate", "accurate", {}),
      ("precise", "precise", {}),
      ("accurate_full", "accurate", dict(scan="full"))),
     "accurate", 0.95),
    ("lightning", dict(partitioning="smart"),
     (("accurate", "accurate", {}), ("precise", "precise", {})),
     "precise", 0.85),
    ("pcaf", {},
     (("balanced", "balanced", {}), ("accurate", "accurate", {}),
      ("precise", "precise", {})),
     "precise", 0.60),
    ("hybrid_lsh", {},
     (("accurate", "accurate", {}), ("precise", "precise", {})),
     "precise", 0.45),
)


def device_share(torch, fn, batches: int = 3) -> dict:
    """Host wall ms per synchronized batch, device ms per batch summed over
    the kernels and copies torch.profiler saw (one stream), the device's
    idle share, and the op that took the most device time; as
    scripts/profile_torch_port.py measures them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / batches * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / batches / 1e3
    top = max(events, key=lambda e: e.self_device_time_total, default=None)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_idle_share=1 - device_ms / wall_ms,
                top_device_op=json.dumps(top.key[:60] if top else None),
                top_device_ms=(top.self_device_time_total / batches / 1e3
                               if top else 0.0))


def families_path(torch, data):
    """The four families ported last at full width: built with bench.py's
    settings, searched at B=1024 against the exact f32 flat index, measured
    with the ported harness, and reloaded in both formats."""
    import tempfile

    import hnsw_tpu_torch as ht
    from hnsw_tpu_torch.bench import measure_build, run_search_benchmark
    from hnsw_tpu_torch.models import FlatIndex, LightningIndex
    from hnsw_tpu_torch.ops import hop, probes, scan
    from hnsw_tpu_torch.types import Corpus

    kernels = (hop.hop_score, hop.hop_score_int8, scan.bucket_topk,
               scan.int8_bucket_topk, scan.exact_topk_sweep,
               scan.int8_sweep_topk, scan.int8_packed_topk, probes.mm_only,
               probes.mm_only_nt, probes.mm_only_kmajor, probes.matmul_only,
               probes.matmul_min)
    before = [fn.launches for fn in kernels]
    corpus = Corpus.from_array(data, metric="cosine")
    q = corpus.pad_queries(data[:1024])
    _, truth = FlatIndex(corpus).search_batch(q, K)
    with tempfile.TemporaryDirectory() as tmp:
        for fam, kw, runs, bar_mode, bar in FAMILIES7:
            idx, build_s = measure_build(
                lambda: ht.build_index(corpus, fam, **kw))
            recalls, rows = {}, {}
            fields = {}
            for label, mode, opts in runs:
                d, r = idx.search_batch(q, K, mode, **opts)
                check(bool(torch.isfinite(d[r >= 0]).all()),
                      f"{fam} {label}: non-finite distances")
                check(bool((r >= 0).all()), f"{fam} {label}: row -1")
                recalls[label] = recall(r, truth)
                rows[label] = r
                if fam == "ivf_flat" and label == bar_mode:
                    fields["last_grouped_dropped_pairs"] = \
                        idx.index_info()["last_grouped_dropped_pairs"]
            if fam == "ivf_flat":
                agree = recall(rows["accurate_full"], rows["accurate"])
                fields["grouped_full_agreement"] = agree
                check(agree >= 0.97, f"ivf_flat: grouped and full rows "
                      f"agree {agree} < 0.97")
            if fam == "lightning":
                # random probes of the same share of partitions
                rand = LightningIndex(corpus, idx.table, use_centroids=False,
                                      partitioning=idx.partitioning)
                _, r = rand.search_batch(q, K, "precise")
                check(bool((r >= 0).all()), "lightning random: row -1")
                recalls["precise_random"] = recall(r, truth)
            if fam == "hybrid_lsh":
                info = idx.index_info()
                fields["overflow_dropped_slots"] = \
                    info["overflow_dropped_slots"]
                fields["overflow_rows_unreachable"] = \
                    info["overflow_rows_unreachable"]
            perf = run_search_benchmark(idx, data[:1024], k=K,
                                        mode=bar_mode,
                                        batch_size=1024, warmup=1, iters=3,
                                        single_query_iters=0)
            say("families7", family=fam, **kw, build_seconds=build_s,
                batch=1024, recall_at_10=json.dumps(recalls),
                bar=f"{bar}@{bar_mode}", qps_device=perf["qps_device"],
                qps_batched=perf["qps_batched"], **fields)
            say("families7", stage="profile", family=fam, mode=bar_mode,
                batch=1024, **device_share(
                    torch, lambda: idx.search_batch(q, K, bar_mode)))
            check(recalls[bar_mode] >= bar,
                  f"{fam} {bar_mode}: recall {recalls[bar_mode]} < {bar}")
            for fmt in ("npz", "dir"):
                t0 = time.perf_counter()
                back = ht.load_index(ht.save_index(idx, f"{tmp}/{fam}",
                                                   format=fmt))
                torch.cuda.synchronize()
                reload_s = time.perf_counter() - t0
                check(type(back) is type(idx) and _rows_equal(
                    torch, back.search_batch(q, K, bar_mode)[1],
                    rows[bar_mode]), f"{fam}: rows differ after {fmt} reload")
                say("families7", stage="persist", family=fam, format=fmt,
                    save_load_seconds=reload_s, rows_identical=True)
            del idx, back
            torch.cuda.empty_cache()
    after = [fn.launches for fn in kernels]
    check(after == before, "phase 7 launched a hand-written kernel")


# ---------------------------------------------------------------------------
# phase 8: the large-N path
# ---------------------------------------------------------------------------

def all_kernels():
    from hnsw_tpu_torch.utils.graphs import kernel_wrappers
    return kernel_wrappers()


def overlap(a, b) -> float:
    """Mean row-set overlap |a_i & b_i| / |a_i | b_i| of two adjacencies."""
    scores = []
    for x, y in zip(a, b):
        sx, sy = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        scores.append(len(sx & sy) / max(len(sx | sy), 1))
    return sum(scores) / max(len(scores), 1)


def large_path(torch, n: int = LARGE_ROWS, refine_rounds: int = 2):
    """An HNSW index past LARGE_N through the user's entry points: corpus,
    exact ground truth, build_hnsw_index with bench.py's large settings
    (the bucketed builder), serving in four modes, and the hop kernel of
    its pack held against its plain version at the pack's shape. Returns
    the corpus rows (host) for the builder check."""
    import logging

    from hnsw_tpu_torch.bench import run_search_benchmark
    from hnsw_tpu_torch.bench.kernels import HOP_ROTATIONS, hop_readings
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import FlatIndex, build_hnsw_index
    from hnsw_tpu_torch.ops import hop
    from hnsw_tpu_torch.types import Corpus

    t0 = time.perf_counter()
    data = generate_vectors(n, DIM, distribution="embedding",
                            num_clusters=64, seed=LARGE_SEED)
    gen_s = time.perf_counter() - t0
    corpus = Corpus.from_array(data, metric="cosine")
    q = corpus.pad_queries(data[:1024])
    _, truth = FlatIndex(corpus).search_batch(q, K)
    torch.cuda.synchronize()
    say("large", n=n, dim=DIM, seed=LARGE_SEED, generate_seconds=gen_s,
        corpus_and_truth_seconds=time.perf_counter() - t0 - gen_s)

    # (b) the build: each progress tick closes the stage before it
    stages = {}
    clock = [time.perf_counter(), "start"]

    def progress(stage, frac):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[clock[1]] = stages.get(clock[1], 0.0) + now - clock[0]
        clock[:] = [now, stage]

    plan = logging.StreamHandler(sys.stdout)
    plan.setFormatter(logging.Formatter("[large] %(message)s"))
    blog = logging.getLogger("hnsw_tpu_torch.models.hnsw.build_large")
    blog.setLevel(logging.INFO)
    blog.addHandler(plan)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        hnsw = build_hnsw_index(corpus, progress=progress,
                                large_refine_rounds=refine_rounds,
                                **LARGE_BUILD)
        progress("end", 1.0)
    finally:
        blog.removeHandler(plan)
    build_s = time.perf_counter() - t0
    say("large", build_seconds=build_s, settings=json.dumps(dict(
        LARGE_BUILD, large_refine_rounds=refine_rounds)),
        stage_seconds=json.dumps(stages),
        peak_gib_build=torch.cuda.max_memory_allocated() / 2 ** 30,
        bridge_edges=hnsw.graph.n_bridges, max_level=hnsw.graph.max_level)

    # (c) serving
    hnsw.entry_sample = ENTRY_SAMPLE
    for fn in (hop.hop_score, hop.hop_score_int8):
        fn.launches = 0
    recalls = {}
    for mode in ("turbo", "fast", "balanced", "accurate"):
        d, r, hops = hnsw.search_batch(q, K, mode, debug_hops=True)
        check(bool((r >= 0).all()), f"{n} rows, {mode}: row -1 in the result")
        check(bool(torch.isfinite(d).all()), f"{n} rows, {mode}: non-finite")
        recalls[mode] = recall(r, truth)
        say("large", mode=mode, batch=len(q), recall_at_10=recalls[mode],
            hops=hops)
    check(recalls["accurate"] >= 0.95,
          f"recall {recalls['accurate']} < 0.95 at accurate")
    best = next(m for m in recalls if recalls[m] >= 0.95)
    perf = run_search_benchmark(hnsw, data[:1024], k=K, mode=best,
                                batch_size=1024, warmup=1, iters=3,
                                single_query_iters=0)
    say("large", mode=best, batch=1024, recall_at_10=recalls[best], bar=0.95,
        qps_device=perf["qps_device"], qps_batched=perf["qps_batched"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # (d) the hop kernel of this pack, at its shape, on 64 queries and the
    # neighbourhoods of their first four results
    pack = hnsw._shadow.nbr_pack
    int8 = pack.dtype == torch.int8
    name = "hop_score_int8" if int8 else "hop_score"
    fn = hop.hop_score_int8 if int8 else hop.hop_score
    plain = hop.hop_score_int8_plain if int8 else hop.hop_score_plain
    check(fn.launches > 0, f"{n} rows: {name} was not launched")
    served_launches = fn.launches
    qlp = torch.matmul(q[:64], hnsw._shadow.proj).contiguous()
    sel = r[:64, :4].to(torch.int32).contiguous()
    got, want = fn(pack, qlp, sel), plain(pack, qlp, sel)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    for err, w in zip(errs, want):
        check(err <= 1e-4 * float(w.abs().max()),
              f"{name} disagrees with its plain version: {errs}")
    say("large", kernel=name, pack_dtype=str(pack.dtype).replace("torch.", ""),
        shape="B=64,E=4,M0={},D={},N_pad={}".format(
            pack.shape[1], pack.shape[2], pack.shape[0]),
        pack_gib=pack.numel() * pack.element_size() / 2 ** 30,
        max_abs_err=max(errs), tol="1e-4*max|plain|",
        launches_serving=served_launches)

    # (e) the hop of this pack timed at its serving shape, B = 1,024 and
    # E = 4: the first four result rows of 1,024 corpus rows, over
    # HOP_ROTATIONS batches of them (one batch's blocks, about 35 MB at
    # D = 128, stay in the L2 across calls on the same operands)
    draws = []
    for k in range(HOP_ROTATIONS):
        qk = corpus.pad_queries(data[1024 * k:1024 * (k + 1)])
        _, rk = hnsw.search_batch(qk, K, best)
        draws.append((torch.matmul(qk, hnsw._shadow.proj).contiguous(),
                      rk[:, :4].to(torch.int32).contiguous()))
    outs = 1 if int8 else 2
    t = hop_readings(fn, pack, draws, outs)
    say("large", kernel=name, shape="B=1024,E=4,M0={},D={},N_pad={}".format(
        pack.shape[1], pack.shape[2], pack.shape[0]), operands="served rows",
        **t)
    # the comparison, the timing and their searches are not the path's
    fn.launches = served_launches
    del hnsw, pack, corpus, draws
    torch.cuda.empty_cache()
    return data


def builder_card_vs_cpu(torch, data):
    """build_layer_clustered on the card and on the CPU at 8,192 x 768:
    the CPU path is held against the JAX package by the tests, so the card
    must give the CPU's rows."""
    import numpy as np

    from hnsw_tpu_torch.models.hnsw.build_large import build_layer_clustered
    from hnsw_tpu_torch.types import Corpus

    sub = data[:8192]
    rows = np.arange(len(sub), dtype=np.int32)
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        c = Corpus.from_array(sub, metric="cosine", device=dev)
        t0 = time.perf_counter()
        out[dev] = build_layer_clustered(
            c.vectors, c.sq_norms, rows, cap=32, k_cand=64, metric="cosine",
            cluster_size=1024, n_probe_clusters=2, refine_rounds=1,
            precision="highest")
        secs[dev] = time.perf_counter() - t0
    ov = overlap(out["cuda"], out["cpu"])
    say("large", stage="builder_card_vs_cpu", n=len(sub), dim=DIM,
        overlap=ov, bar=0.98, identical_rows=float(
            (out["cuda"] == out["cpu"]).all(axis=1).mean()),
        card_seconds=secs["cuda"], cpu_seconds=secs["cpu"])
    check(ov >= 0.98, f"builder card against CPU: overlap {ov} < 0.98")


def merges_path(torch, index, queries):
    """Phase 4's HNSW index served at balanced with each beam merge. The
    index has no merge option (nor has the reference's), so the merge is
    bound into the search its search_batch calls, and the searches it
    captured before are dropped, so that each merge is captured anew."""
    import functools

    import hnsw_tpu_torch.models.hnsw as hmod

    real = hmod._search_batch
    rows, ms = {}, {}
    try:
        for merge in ("sort", "bitonic", "approx"):
            hmod._search_batch = functools.partial(real, merge=merge)
            index._drop_graphs()
            rows[merge] = index.search_batch(queries, K, "balanced")[1]
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                index.search_batch(queries, K, "balanced")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[merge] = statistics.median(times)
    finally:
        hmod._search_batch = real
        index._drop_graphs()
    agree = {m: _row_agreement(rows[m], rows["sort"])
             for m in ("bitonic", "approx")}
    say("large", stage="merges", n=index.corpus.n, batch=len(queries),
        mode="balanced", batch_ms=json.dumps(ms),
        row_agreement_with_sort=json.dumps(agree), bar=0.999)
    for m, a in agree.items():
        check(a >= 0.999, f"merge {m}: row agreement {a} < 0.999")


def large_phase(torch, served, queries):
    """Phase 8: the large-N path, the builder on card against CPU, and the
    merges; launch counts zeroed just before and read just after."""
    kernels = all_kernels()
    for fn in kernels:
        fn.launches = 0
    data = large_path(torch)
    builder_card_vs_cpu(torch, data)
    merges_path(torch, served, queries)
    launches = {fn.__name__: fn.launches for fn in kernels}
    say("large", launches=json.dumps(launches))
    check(launches["hop_score"] > 0, "hop_score was not launched in phase 8")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the multi-device layer and the tools
# ---------------------------------------------------------------------------

def batch_ms(torch, fn, reps: int = 3) -> float:
    """Median host ms of `reps` synchronized calls, after one untimed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sharded_searches(torch, corpus, q, truth, exact_d, meshes, ms):
    """ShardedFlatIndex, sharded_lloyd_step and ShardedIVFFlat on each mesh
    against their unsharded twins."""
    from hnsw_tpu_torch.models import build_ivf_flat_index
    from hnsw_tpu_torch.ops.kmeans import lloyd
    from hnsw_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFFlat
    from hnsw_tpu_torch.parallel.sharded import sharded_lloyd_step

    # (1) the row-sharded exact search against phase 4's exact f32 index
    for name, mesh in meshes.items():
        sflat = ShardedFlatIndex(corpus, mesh)
        d, r = sflat.search_batch(q, K)
        err = float((d - exact_d).abs().max())
        same = _rows_equal(torch, r, truth)
        say("parallel", stage="flat", mesh=name, batch=len(q),
            rows_identical=same, max_abs_err=err, tol=1e-5)
        check(same and err <= 1e-5, f"sharded flat on {name}: rows "
              f"identical {same}, distance error {err}")
        ms[f"flat_{name}"] = batch_ms(torch, lambda: sflat.search_batch(q, K))
        del sflat

    # (2) one Lloyd step of 128 centroids (the corpus's first rows), against
    # ops/kmeans.lloyd: iters=1 for the centroids, iters=0 for the
    # assignment to the centroids the step starts from
    dev = corpus.device
    valid = torch.arange(corpus.n_pad, device=dev) < corpus.n
    cents0 = corpus.vectors[:128]
    want_c, _ = lloyd(corpus.vectors, corpus.sq_norms, valid, cents0,
                      iters=1, metric=corpus.metric)
    _, want_a = lloyd(corpus.vectors, corpus.sq_norms, valid, cents0,
                      iters=0, metric=corpus.metric)
    for name, mesh in meshes.items():
        grow = -corpus.n_pad % mesh.size
        pad = torch.nn.functional.pad
        args = (pad(corpus.vectors, (0, 0, 0, grow)),
                pad(corpus.sq_norms, (0, grow)),
                torch.arange(corpus.n_pad + grow, device=dev) < corpus.n)
        cents, assign = sharded_lloyd_step(mesh, *args, cents0,
                                           metric=corpus.metric)
        assign = torch.cat([a.to(mesh.first) for a in assign])[:corpus.n_pad]
        err = float((cents - want_c).abs().max())
        same = _rows_equal(torch, assign, want_a)
        say("parallel", stage="lloyd", mesh=name, k=128, max_abs_err=err,
            tol=1e-4, assignments_identical=same)
        check(err <= 1e-4 and same, f"sharded Lloyd on {name}: centroid "
              f"error {err}, assignments identical {same}")
        ms[f"lloyd_{name}"] = batch_ms(torch, lambda: sharded_lloyd_step(
            mesh, *args, cents0, metric=corpus.metric))

    # (3) the cluster-sharded IVF scan over bench.py's IVF-FLAT (128
    # partitions, spill), against the unsharded masked f32 scan (the
    # reference's sharded scan is that scan); the default grouped scan
    # scores bf16 operands, and its agreement is printed
    ivf = build_ivf_flat_index(corpus, num_partitions=128, spill=1)
    _, want_r = ivf.search_batch(q, K, "accurate", scan="full")
    _, grouped_r = ivf.search_batch(q, K, "accurate")
    for name, mesh in meshes.items():
        sivf = ShardedIVFFlat(ivf, mesh)
        d, r = sivf.search_batch(q, K, "accurate")
        same = _rows_equal(torch, r, want_r)
        rec = recall(r, truth)
        say("parallel", stage="ivf_flat", mesh=name, batch=len(q),
            mode="accurate", rows_identical_full_scan=same,
            row_agreement_grouped=_row_agreement(r, grouped_r),
            recall_at_10=rec, bar=0.95)
        check(same and rec >= 0.95, f"sharded IVF on {name}: rows "
              f"identical {same}, recall {rec}")
        ms[f"ivf_accurate_{name}"] = batch_ms(
            torch, lambda: sivf.search_batch(q, K, "accurate"))
        del sivf
    del ivf


def parallel_path(torch, data):
    """Phase 9 on phase 4's corpus with 1,024 of its rows as queries: the
    sharded searches, the Lloyd step and the sharded build on the card as
    a mesh of one and on a virtual mesh of four cuda:0 entries, the dry
    run on each, then the bench CLI, the shell and the native parser.
    Returns the launch counts of the phase."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from hnsw_tpu_torch.apps.shell import SearchShell
    from hnsw_tpu_torch.bench import cli
    from hnsw_tpu_torch.io import native
    from hnsw_tpu_torch.io.loader import load_json_corpus
    from hnsw_tpu_torch.models import FlatIndex
    from hnsw_tpu_torch.ops import hop
    from hnsw_tpu_torch.parallel import (ShardedPartitionedHNSW,
                                         build_partitioned_hnsw_sharded,
                                         make_mesh)
    from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip
    from hnsw_tpu_torch.types import Corpus

    kernels = all_kernels()
    for fn in kernels:
        fn.launches = 0
    corpus = Corpus.from_array(data, metric="cosine")
    q = corpus.pad_queries(data[:1024])
    exact_d, truth = FlatIndex(corpus).search_batch(q, K)
    meshes = {"card": make_mesh(), "virtual4": make_mesh(4, device="cuda:0")}
    check(meshes["card"].size == 1, f"make_mesh() has "
          f"{meshes['card'].size} entries on a machine of one card")
    ms = {}
    sharded_searches(torch, corpus, q, truth, exact_d, meshes, ms)

    # (4) the sharded build (8 partitions, M=16) on the virtual mesh
    t0 = time.perf_counter()
    pidx = build_partitioned_hnsw_sharded(corpus, num_partitions=8,
                                          mesh=meshes["virtual4"], M=16)
    torch.cuda.synchronize()
    say("parallel", stage="build", mesh="virtual4", partitions=8, M=16,
        build_seconds=time.perf_counter() - t0,
        max_level=int(pidx.adj_upper_p.shape[1]))
    rows = {}
    for name, mesh in meshes.items():
        sp = ShardedPartitionedHNSW(pidx, mesh)
        d, r = sp.search_batch(q, K, "precise")
        rows[name] = r
        rec = recall(r, truth)
        check(bool((r >= 0).all()) and bool(torch.isfinite(d).all()),
              f"sharded partitioned on {name}: row -1 or non-finite")
        say("parallel", stage="partitioned_hnsw", mesh=name, batch=len(q),
            mode="precise", recall_at_10=rec, bar=0.95)
        check(rec >= 0.95, f"sharded partitioned on {name}: recall {rec}")
        ms[f"partitioned_precise_{name}"] = batch_ms(
            torch, lambda: sp.search_batch(q, K, "precise"), reps=1)
        del sp
    same = _rows_equal(torch, rows["card"], rows["virtual4"])
    say("parallel", stage="partitioned_hnsw", rows_identical_1_4=same)
    check(same, "sharded partitioned: meshes of 1 and 4 give other rows")
    # the same index through its single-device search (the packed hop path)
    before = hop.hop_score.launches
    d, r = pidx.search_batch(q, K, "accurate")
    check(hop.hop_score.launches > before,
          "single-device partitioned search did not launch hop_score")
    rec = recall(r, truth)
    say("parallel", stage="partitioned_hnsw", mesh="none (search_batch)",
        mode="accurate", recall_at_10=rec,
        hop_score_launches=hop.hop_score.launches - before)
    ms["partitioned_single_accurate"] = batch_ms(
        torch, lambda: pidx.search_batch(q, K, "accurate"))
    del pidx
    torch.cuda.empty_cache()

    # (5) the dry run, once on each mesh
    for name, n, dev in (("card", 1, None), ("virtual4", 4, "cuda:0")):
        t0 = time.perf_counter()
        dryrun_multichip(n, device=dev)
        say("parallel", stage="dryrun_multichip", mesh=name,
            seconds=time.perf_counter() - t0)
    say("parallel", batch_ms=json.dumps(ms), note="the virtual mesh's four "
        "shards share one card and one stream: its times say nothing of a "
        "speed-up on several cards")

    # (6) the tools
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["quick", "1000"])
        check(rc == 0, f"bench.cli quick: exit code {rc}")
        lines = [ln for ln in out.getvalue().splitlines() if "recall@" in ln]
        check(len(lines) == len(cli.QUICK_FAMILIES),
              f"bench.cli quick printed {len(lines)} family lines")
        for line in lines:
            say("tools", cli_quick=json.dumps(" ".join(line.split())))

        # a JSON corpus of 2,000 x 768 (past 4 MiB, so the native parser
        # reads it), loaded, served by the shell, then parsed both ways
        sub = data[:2000]
        path = f"{tmp}/corpus.json"
        with open(path, "w") as f:
            json.dump({"metadata": {"source": "chip_smoke"}, "verses": [
                {"id": f"v{i}", "text": f"verse {i} of the stand-in",
                 "embedding": sub[i].tolist()} for i in range(len(sub))]}, f)
        t1 = time.perf_counter()
        parsed = native.parse_corpus(path)
        native_s = time.perf_counter() - t1
        check(parsed is not None, "the native parser did not read the corpus")
        pairs, texts, _ = load_json_corpus(path)
        with open(path) as f:
            items = json.load(f)["verses"]
        same = ([p[0] for p in pairs] == [it["id"] for it in items] ==
                parsed[1]) and all(
            (p[1] == np.asarray(it["embedding"], np.float32)).all()
            for p, it in zip(pairs, items)) and \
            texts == {it["id"]: it["text"] for it in items}
        check(same, "load_json_corpus differs from the json module")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            shell = SearchShell(path)
            seed = shell.find_seed("verse 17 of")
            shell.query("verse 17 of", k=5)
            shell.stats()
        text = out.getvalue()
        check(seed == "v17" and "seed: v17" in text and "%" in text
              and "hnsw" in text, f"shell: seed {seed}, output {text[-300:]!r}")
        say("tools", native_parse_seconds=native_s, rows=len(pairs),
            loader_identical=same, shell_seed=seed,
            shell_top=json.dumps(shell.index.search(
                shell.data[17], 3)[0]["id"]))
        del shell
    say("tools", seconds=time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in kernels}
    say("parallel", launches=json.dumps(launches))
    check(launches["hop_score"] > 0, "hop_score was not launched in phase 9")
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
    check_gather_kernel(torch, records)
    check_scan_kernels(torch, data, records)
    check_sweep_kernels(torch, data, records)
    check_packed_kernel(torch, data, records)
    floor_ms = check_probe_kernels(torch, data, records)
    torch.cuda.empty_cache()

    launches, served = main_path(torch, data)
    torch.cuda.empty_cache()
    t4b = time.perf_counter()
    loop_launches = device_loop_path(torch, served, data, records)
    say("device_loop", seconds=time.perf_counter() - t4b)
    torch.cuda.empty_cache()
    api_launches = api_path(torch, data)
    torch.cuda.empty_cache()
    probe_launches = probe_path(torch, data, records, floor_ms)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    families_path(torch, data)
    say("families7", seconds=time.perf_counter() - t7)
    t8 = time.perf_counter()
    large_launches = large_phase(torch, served, data[:1024])
    say("large", seconds=time.perf_counter() - t8)
    del served
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    parallel_launches = parallel_path(torch, data)
    say("parallel", seconds=time.perf_counter() - t9)
    out = []
    for name in KERNELS:
        rec = records[name]
        rec["launches"] = sum(
            phase.get(name, 0) for phase in (
                launches, loop_launches, api_launches, probe_launches,
                large_launches, parallel_launches))
        check(rec["launches"] > 0, f"{name} was not launched in phases 4-9")
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

"""Operands and calls of the flat-scan kernels and their matmul floors at the
probe scripts' shapes, and of the two hop kernels at the main path's hop
shapes, for the scripts that time them on the card (``chip_smoke.py``,
``scripts/probe_torch.py``, ``scripts/time_bank_kernels.py``,
``scripts/hop_ablate.py``).

The corpus is packed for cosine and padded as the scans pad it: bf16 to
31,744 rows (``bucket_topk``, ``exact_topk_sweep``), and bf16 and int8 to
the probes' round_up(n_pad, 4096) rows (32,768 at 31,173 rows; the int8
scans and the floors). Queries are the first 1,024 or 4,096 corpus rows.
Each kernel module is imported inside the function that calls it, so the
scan calls also time a tree that has no floors.
"""

from __future__ import annotations

import itertools
import statistics
import time
from typing import Callable, NamedTuple

import torch

# the int8 floors' corpus tile (INT8_NT of the TPU scans)
FLOOR_NT = 2048
BF16_PACK = 31744
# the hops of the main path: B queries, E selected blocks of M0 rows, D, and
# the packed blocks. (a) phase 4's HNSW serving of the 31,173-row corpus;
# (b) hop width 256 (E = 8), partitioned HNSW and IVF-HNSW (phases 6 and 9);
# (c) phase 8's 500,000-row index served from its 128-dim pack (4.1 GB)
HOP_SHAPES = {
    "a": dict(b=1024, e=4, m0=32, d=768, n_pad=31176),
    "b": dict(b=1024, e=8, m0=32, d=768, n_pad=31176),
    "c": dict(b=1024, e=4, m0=32, d=128, n_pad=500000),
}
HOP_SHAPE = HOP_SHAPES["a"]
# independent (queries, sel) draws a rotated timing cycles through: one call
# at (c) reads about 35 MB, which the 50 MB L2 keeps for the next call on
# the same operands; eight draws read well over 50 MB at every shape
HOP_ROTATIONS = 8
# HBM3 bytes/s of the H100 SXM (NVIDIA data sheet), for the hop bounds
HBM_BYTES_S = 3.35e12


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms over `reps` runs (CUDA events)."""
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


def burst_ms(fn, calls: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of one fn() in ms, from `reps` runs of `calls`
    back-to-back calls between two CUDA events: a kernel that takes longer
    than its wrapper's host work keeps the card busy, so this reads its
    device time where median_ms also counts the host work before the one
    launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def probe_operands(data, device=None) -> dict:
    """The scans' and floors' operands of `data` [n, D] (cosine)."""
    from hnsw_tpu_torch.models.flat import quantize_rows
    from hnsw_tpu_torch.ops import scan
    from hnsw_tpu_torch.types import Corpus

    corpus = Corpus.from_array(data, metric="cosine", device=device)
    pad = torch.nn.functional.pad
    n_pad = -(-corpus.n_pad // 4096) * 4096
    extra = n_pad - corpus.n_pad
    vb = pad(corpus.vectors.to(torch.bfloat16), (0, 0, 0, extra))
    vsq = pad(corpus.sq_norms, (0, extra))
    v8, vs = quantize_rows(corpus.vectors)
    v8, vs = pad(v8, (0, 0, 0, extra)), pad(vs, (0, extra))
    qf = corpus.pad_queries(data[:4096])
    q8, qs = quantize_rows(qf)
    vk8 = scan.int8_vkey(vs, vsq, "cosine")
    return dict(
        corpus=corpus, n=corpus.n, qf=qf,
        q1024=qf[:1024].to(torch.bfloat16), q4096=qf.to(torch.bfloat16),
        v=vb, vT=vb.T.contiguous(), vsq=vsq,
        v31744=vb[:BF16_PACK].contiguous(), vsq31744=vsq[:BF16_PACK],
        vkey31744=scan.bf16_vkey(vsq[:BF16_PACK], "cosine"),
        v8=v8, vs=vs, vk8=vk8, nvk8=-vk8, q8=q8, qs=qs,
        qmeta=torch.stack([qs, (qf * qf).sum(1)], dim=1))


def scan_calls(x) -> dict:
    """kernel name -> a call of its bank or top-k at B = 4096, with the
    options chip_smoke.py's phase 3 times it at."""
    from hnsw_tpu_torch.ops import scan

    n = x["n"]
    return {
        "bucket_topk": lambda: scan.bucket_bank(
            x["v31744"], x["vkey31744"], x["q4096"], n, metric="cosine"),
        "exact_topk_sweep": lambda: scan.exact_topk_sweep(
            x["v31744"], x["vsq31744"], x["q4096"], n, k=10, metric="cosine",
            bt=512),
        "int8_bucket_topk": lambda: scan.int8_bucket_bank(
            x["v8"], x["vk8"], x["vs"], x["q8"], x["qs"], n, metric="cosine"),
        "int8_sweep_topk": lambda: scan.int8_sweep_topk(
            x["v8"], x["vs"], x["vsq"], x["q8"], x["qmeta"], n, k=16,
            metric="cosine", bt=256, nt=1024),
        "int8_packed_topk": lambda: scan.int8_packed_bank(
            x["v8"], x["nvk8"], x["q8"], n),
    }


class FloorCall(NamedTuple):
    kernel: Callable      # the wrapper of ops/probes.py
    plain: Callable       # its plain PyTorch version
    library: Callable     # one PyTorch call computing the same function
    args: tuple
    kwargs: dict

    def __call__(self):
        return self.kernel(*self.args, **self.kwargs)

    def run_plain(self):
        return self.plain(*self.args, **self.kwargs)


def floor_calls(x) -> dict:
    """reading -> FloorCall: the bf16 floors at B=1024 over the 32,768-row
    pack (r4e, r4f), mm_only at bucket_topk's B=4096 over its 31,744-row
    pack, and the int8 floors at B=4096, nt=2048 (r5a, r5c)."""
    from hnsw_tpu_torch.ops import probes

    def colsum(dots):
        return dots.float().reshape(dots.shape[0], -1, 128).sum(1)

    q1, q4, v, vT, v31 = x["q1024"], x["q4096"], x["v"], x["vT"], x["v31744"]
    q8, v8 = x["q8"], x["v8"]
    v8t = v8.T
    lo = (v8.shape[0] // FLOOR_NT - 1) * FLOOR_NT
    g = FLOOR_NT // 128
    nt = dict(nt=FLOOR_NT)
    return {
        "mm_only_b1024": FloorCall(
            probes.mm_only, probes.mm_only_plain,
            lambda: colsum(torch.matmul(q1, v.T)), (q1, v), {}),
        "mm_only_nt_b1024": FloorCall(
            probes.mm_only_nt, probes.mm_only_plain,
            lambda: colsum(torch.matmul(q1, v.T)), (q1, v), {}),
        "mm_only_kmajor_b1024": FloorCall(
            probes.mm_only_kmajor, probes.mm_only_kmajor_plain,
            lambda: colsum(torch.matmul(q1, vT)), (q1, vT), {}),
        "mm_only_b4096_n31744": FloorCall(
            probes.mm_only, probes.mm_only_plain,
            lambda: colsum(torch.matmul(q4, v31.T)), (q4, v31), {}),
        "matmul_only_b4096_nt2048": FloorCall(
            probes.matmul_only, probes.matmul_only_plain,
            lambda: torch._int_mm(q8, v8t)[:, lo:lo + 128], (q8, v8), nt),
        "matmul_min_b4096_nt2048": FloorCall(
            probes.matmul_min, probes.matmul_min_plain,
            lambda: torch._int_mm(q8, v8t)[:, lo:lo + FLOOR_NT]
            .reshape(q8.shape[0], g, 128).amin(1), (q8, v8), nt),
    }


def hop_operands(seed: int = 42, device="cuda", shape: dict = HOP_SHAPE,
                 pack=None, codes: bool = True,
                 rotations: int = 1) -> dict:
    """Random operands of one hop at `shape`: queries [B, D] f32, selected
    blocks [B, E] int32 (-1 included), a bf16 pack and (with `codes`) int8
    codes [N_pad, M0, D]; `pack` reuses a pack of the same N_pad, M0 and D.
    `draws` holds `rotations` (queries, sel) pairs, the first of them
    (queries, sel)."""
    b, e, m0, d, n_pad = (shape[k] for k in ("b", "e", "m0", "d", "n_pad"))
    g = torch.Generator(device=device).manual_seed(seed)
    queries = torch.randn(b, d, generator=g, device=device)
    sel = torch.randint(-1, n_pad, (b, e), generator=g, device=device,
                        dtype=torch.int32)
    if pack is None:
        pack = torch.randn(n_pad, m0, d, generator=g,
                           device=device).to(torch.bfloat16)
    out = dict(queries=queries, sel=sel, pack=pack)
    if codes:
        out["codes"] = torch.randint(-127, 128, (n_pad, m0, d), generator=g,
                                     device=device, dtype=torch.int8)
    out["draws"] = [(queries, sel)] + [
        (torch.randn(b, d, generator=g, device=device),
         torch.randint(-1, n_pad, (b, e), generator=g, device=device,
                       dtype=torch.int32)) for _ in range(rotations - 1)]
    return out


def hop_library(tensor, queries, sel):
    """The hop's yardstick: the blocks gathered by one indexing call and
    scored by one bf16 einsum (no squared norms), as a callable."""
    rows = torch.clamp(sel, min=0).long()
    qb = queries.to(torch.bfloat16)
    return lambda: torch.einsum("bd,bemd->bem", qb,
                                tensor[rows].to(torch.bfloat16))


def hop_bytes(pack, queries, sel, outs: int) -> int:
    """Bytes one hop must move: each distinct selected block once, the
    queries, the rows and `outs` f32 outputs of [B, E*M0]."""
    _, m0, d = pack.shape
    b, e = sel.shape
    uniq = int(torch.unique(torch.clamp(sel, min=0)).numel())
    return (uniq * m0 * d * pack.element_size() + b * d * 4 + b * e * 4
            + outs * b * e * m0 * 4)


def hop_readings(fn, pack, draws, outs: int, host_calls: int = 1000) -> dict:
    """A hop wrapper `fn(pack, queries, sel)` timed on the card: one call
    (ms) and one of 20 back to back (back_to_back_ms) on the first draw,
    the same two cycling through every draw (rotated_*: the working set
    exceeds L2), the host microseconds of one call (perf_counter around
    `host_calls` calls with no sync), and each reading's bound from its
    bytes over HBM_BYTES_S (rotated: the mean over the draws)."""
    q, s = draws[0]
    ring = itertools.cycle(draws)

    def same():
        return fn(pack, q, s)

    def rotated():
        return fn(pack, *next(ring))

    same()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        same()
    host_us = (time.perf_counter() - t0) * 1e6 / host_calls
    torch.cuda.synchronize()
    nbytes = [hop_bytes(pack, dq, ds, outs) for dq, ds in draws]
    return dict(
        ms=median_ms(same, reps=30), back_to_back_ms=burst_ms(same),
        rotated_ms=median_ms(rotated, reps=30),
        rotated_back_to_back_ms=burst_ms(rotated, calls=3 * len(draws)),
        host_us=host_us, bound_ms=nbytes[0] / HBM_BYTES_S * 1e3,
        rotated_bound_ms=statistics.mean(nbytes) / HBM_BYTES_S * 1e3)

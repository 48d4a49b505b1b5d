"""Operands and calls of the flat-scan kernels and their matmul floors at the
probe scripts' shapes, for the scripts that time them on the card
(``chip_smoke.py``, ``scripts/probe_torch.py``,
``scripts/time_bank_kernels.py``).

The corpus is packed for cosine and padded as the scans pad it: bf16 to
31,744 rows (``bucket_topk``, ``exact_topk_sweep``), and bf16 and int8 to
the probes' round_up(n_pad, 4096) rows (32,768 at 31,173 rows; the int8
scans and the floors). Queries are the first 1,024 or 4,096 corpus rows.
Each kernel module is imported inside the function that calls it, so the
scan calls also time a tree that has no floors.
"""

from __future__ import annotations

import statistics
from typing import Callable, NamedTuple

import torch

# the int8 floors' corpus tile (INT8_NT of the TPU scans)
FLOOR_NT = 2048
BF16_PACK = 31744


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

"""Flat / exact brute-force index. Counterpart of ``hnsw_tpu/models/flat.py``.

One product + masked top-k per corpus tile, streamed with a running merge so
arbitrarily large corpora fit in fixed device memory. In f32 it is the recall
ground truth every approximate family is measured against; its bf16 and int8
forms are the fused scans of ``ops/scan.py`` (bucketed, sweep or packed, by
``scan_kernel``), which run their hand-written CUDA kernels when the corpus
lies on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from hnsw_tpu_torch.config import Mode
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.ops.distance import (BIG, as_bf16_f32, distances_from_dots,
                                         gather_score)
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Corpus, Metric, round_up

# Corpus-tile row count for the streaming scan.
DEFAULT_TILE = 32768


def exact_topk(vectors, v_sq, queries, *, k: int, n, metric: Metric,
               tile: int = DEFAULT_TILE, precision: str = "f32",
               row_mask=None):
    """Exact top-k over the packed corpus. Returns (dists [B,k], rows [B,k]
    int32); rows >= n never appear (masked to BIG); if k > n the tail has
    row -1. row_mask (bool [N_pad], optional) excludes rows exactly."""
    n = int(n)
    n_pad, d = vectors.shape
    b = queries.shape[0]
    kk = min(k, n_pad)
    dev = vectors.device

    q = as_bf16_f32(queries) if precision == "bf16" else queries
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)

    def score_tile(vt, vt_sq, base, mask_t=None):
        vv = as_bf16_f32(vt) if precision == "bf16" else vt
        dots = torch.matmul(q, vv.T)
        dist = distances_from_dots(dots, q_sq, vt_sq, metric)
        rows = base + torch.arange(vt.shape[0], dtype=torch.int32, device=dev)
        rows = rows.expand(b, -1)
        dist = torch.where(rows < n, dist, BIG)
        if mask_t is not None:
            dist = torch.where(mask_t[None, :], dist, BIG)
        return dist, rows

    if n_pad <= tile:
        dist, rows = score_tile(vectors, v_sq, 0, row_mask)
        dk, sel = top_k_ascending(dist, kk)
        rk = torch.gather(rows, -1, sel)
    else:
        dk = torch.full((b, kk), BIG, dtype=torch.float32, device=dev)
        rk = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
        for base in range(0, n_pad, tile):
            hi = min(base + tile, n_pad)
            mask_t = row_mask[base:hi] if row_mask is not None else None
            dist, rows = score_tile(vectors[base:hi], v_sq[base:hi], base,
                                    mask_t)
            d_all = torch.cat([dk, dist], dim=-1)
            r_all = torch.cat([rk, rows], dim=-1)
            dk, sel = top_k_ascending(d_all, kk)
            rk = torch.gather(r_all, -1, sel)

    # normalize missing results (k > n) to row -1
    rk = torch.where(dk >= BIG, -1, rk)
    if kk < k:
        dk = torch.nn.functional.pad(dk, (0, k - kk), value=BIG)
        rk = torch.nn.functional.pad(rk, (0, k - kk), value=-1)
    return dk, rk


def quantize_rows(x):
    """Per-row symmetric int8 quantization: (codes int8, scale f32 [rows])."""
    xmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    scale = torch.clamp(xmax / 127.0, min=1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def int8_topk(v8, vscale, vectors, v_sq, queries, n, *, k: int, fetch: int,
              metric: Metric):
    """Two-phase quantized scan in plain torch: int8 coarse pass (per-row
    symmetric quantization) -> exact f32 re-rank of the top `fetch`
    candidates. fetch <= 0 selects COARSE-ONLY mode: the dequantized coarse
    ordering and distances are returned directly."""
    n = int(n)
    q8, qscale = quantize_rows(queries)
    # int8 x int8 dots of D <= 1040 stay below 2^24: exact in f32
    dots = torch.matmul(q8.float(), v8.float().T)
    dots = dots * qscale[:, None] * vscale[None, :]
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    dist = distances_from_dots(dots, q_sq, v_sq, metric)
    rows = torch.arange(dist.shape[-1], device=dist.device).expand_as(dist)
    dist = torch.where(rows < n, dist, BIG)
    if fetch <= 0:          # coarse-only: no exact re-rank
        dk, cand = top_k_ascending(dist, min(k, dist.shape[-1]))
        return dk, torch.where(dk < BIG, cand, -1).to(torch.int32)
    _, cand = top_k_ascending(dist, min(fetch, dist.shape[-1]))
    d = gather_score(queries, torch.clamp(cand, min=0), vectors, v_sq,
                     metric=metric, valid=cand < n)
    dk, sel = top_k_ascending(d, k)
    rk = torch.where(dk < BIG, torch.gather(cand, -1, sel), -1)
    return dk, rk.to(torch.int32)


class FlatIndex(ANNIndex):
    """Exact brute-force index (recall = 1.0 by construction with the
    default f32 precision). precision="bf16" takes the fused scan on the
    card (~1e-3 distance error); precision="int8" takes a quantized coarse
    pass with exact re-rank (or coarse-only with int8_fetch=0)."""

    family = "flat"

    def __init__(self, corpus: Corpus, *, precision: str = "f32",
                 tile: int = DEFAULT_TILE, scan_kernel: str = "auto",
                 int8_fetch: int | None = None):
        super().__init__(corpus)
        self.precision = precision
        self.tile = tile
        # int8 path: how many coarse candidates the exact f32 re-rank
        # considers (None = auto, k+6); int8_fetch=0 selects coarse-only
        self.int8_fetch = int8_fetch
        # "auto" | "bucket" | "sweep" | "packed": the fused selection kernel
        # of the bf16/int8 paths on the card. "bucket" keeps the best two
        # rows of 128 buckets (exact up to 3-way bucket collisions); "sweep"
        # keeps an exact running top-k; "packed" (int8 cosine/dot) runs the
        # bucket selection on packed int32 keys; "auto" resolves to "bucket"
        self.scan_kernel = scan_kernel
        self._kernel_arrays = None        # bf16 scan: (vectors, v_sq)
        self._int8_arrays = None          # plain int8: (codes, scales)
        self._int8_kernel_arrays = None   # int8 scan: padded to INT8_NT
        self._packed_ok = None            # DOT keys inside the packed bias

    def _use_bucket(self) -> bool:
        # "packed" is int8-specific; the bf16 path treats it as bucket
        return self.scan_kernel in ("auto", "bucket", "packed")

    def _on_card(self) -> bool:
        return self.corpus.device.type == "cuda"

    def _get_int8_arrays(self):
        if self._int8_arrays is None:
            self._int8_arrays = quantize_rows(self.corpus.vectors)
        return self._int8_arrays

    def _packed_key_bounded(self, v8, vscale) -> bool:
        """Whether every packed DOT key stays inside the bias. The packed
        scan orders keys by the int32 bits of dots*(-vscale) + PACK_BIAS,
        which is right only while that sum is positive. By Cauchy-Schwarz
        |q8 . v8| * vscale <= 127*sqrt(dim) * |v8|*vscale for every int8
        query, so the bound below holds for any query. Cosine keys are
        divided by |v| and stay below 127*sqrt(dim) by themselves; an
        unnormalized DOT corpus can exceed the bias, and then the reference
        returns wrong candidates (its pallas_scan.py:572). The port takes
        the bucket kernel there instead."""
        from hnsw_tpu_torch.ops.scan import PACK_BIAS
        if self._packed_ok is None:
            norms = torch.sqrt(torch.sum(v8.float() ** 2, dim=1)) * vscale
            bound = 127.0 * math.sqrt(self.corpus.dim) * float(norms.max())
            self._packed_ok = bound < PACK_BIAS
        return self._packed_ok

    def _int8_kernel(self, q, k: int, fetch: int):
        """Quantized coarse scan (ops/scan: the bucket, packed or sweep
        kernel) + exact f32 re-rank. fetch <= 0 selects COARSE-ONLY mode:
        distances are rebuilt from the bucket/packed kernels' per-query
        monotone key (the sweep kernel already emits distances) and no row
        is gathered."""
        from hnsw_tpu_torch.ops import scan

        if self._int8_kernel_arrays is None:
            v8, vscale = quantize_rows(self.corpus.vectors)
            # the INT8_NT-aligned pack serves every kernel (2048 is a
            # multiple of the sweep kernel's nt=1024)
            n_pad = round_up(self.corpus.n_pad, scan.INT8_NT)
            extra = n_pad - self.corpus.n_pad
            v8 = torch.nn.functional.pad(v8, (0, 0, 0, extra)).contiguous()
            vs = torch.nn.functional.pad(vscale, (0, extra)).contiguous()
            vsq = torch.nn.functional.pad(self.corpus.sq_norms,
                                          (0, extra)).contiguous()
            self._int8_kernel_arrays = (v8, vs, vsq)
        v8, vs, vsq = self._int8_kernel_arrays

        b = q.shape[0]
        metric = self.corpus.metric
        kname = "bucket" if self.scan_kernel == "auto" else self.scan_kernel
        if kname == "packed" and (
                metric not in (Metric.COSINE, Metric.DOT)
                or (metric == Metric.DOT
                    and not self._packed_key_bounded(v8, vs))):
            kname = "bucket"   # no bias bound: euclidean, unbounded DOT
        if kname in ("bucket", "packed"):
            bt, nt = scan.INT8_BT, scan.INT8_NT
            bt = min(bt, max(round_up(b, 8), 8))
        else:
            bt, nt = min(256, max(round_up(b, 8), 8)), scan.DEFAULT_NT
        b_pad = round_up(b, bt)
        qf = torch.zeros((b_pad, q.shape[1]), dtype=torch.float32,
                         device=q.device)
        qf[:b] = q
        q8, qscale = quantize_rows(qf)
        qmeta = torch.stack([qscale, torch.sum(qf * qf, dim=1)], dim=1)
        if kname == "packed":
            kern = scan.int8_packed_topk
        else:
            kern = scan.int8_bucket_topk if kname == "bucket" \
                else scan.int8_sweep_topk
        dk, cand = kern(v8, vs, vsq, q8.contiguous(), qmeta, self.corpus.n,
                        k=(fetch if fetch > 0 else k), metric=metric, bt=bt,
                        nt=nt)
        if fetch <= 0:
            dk, cand = dk[:b], cand[:b]
            if kname in ("bucket", "packed"):
                qs = qmeta[:b, 0:1]
                q_sq = qmeta[:b, 1:2]
                if metric == Metric.COSINE:
                    # key = -dots_i32 * vscale/|v|; dots_f = dots_i32*qs*vs
                    dist = 1.0 + dk * qs / torch.sqrt(torch.clamp(q_sq,
                                                                  min=1e-12))
                elif metric == Metric.EUCLIDEAN:
                    # key = |v|^2 - 2*qs*vs*dots; d^2 = |q|^2 + key
                    dist = torch.sqrt(torch.clamp(dk + q_sq, min=0.0))
                else:
                    dist = dk * qs
            else:
                dist = dk
            ok = (cand >= 0) & (dk < BIG)
            return torch.where(ok, dist, BIG), torch.where(ok, cand, -1)
        cand = cand[:b]
        d = gather_score(q, torch.clamp(cand, min=0), self.corpus.vectors,
                         self.corpus.sq_norms, metric=metric,
                         valid=cand >= 0)
        dk, sel = top_k_ascending(d, k)
        rk = torch.where(dk < BIG, torch.gather(cand, -1, sel), -1)
        return dk, rk.to(torch.int32)

    def _get_kernel_arrays(self):
        from hnsw_tpu_torch.ops.scan import DEFAULT_NT
        if self._kernel_arrays is None:
            n_pad = round_up(self.corpus.n_pad, DEFAULT_NT)
            extra = n_pad - self.corpus.n_pad
            vec = torch.nn.functional.pad(
                self.corpus.vectors.to(torch.bfloat16), (0, 0, 0, extra))
            vsq = torch.nn.functional.pad(self.corpus.sq_norms, (0, extra))
            self._kernel_arrays = (vec.contiguous(), vsq.contiguous())
        return self._kernel_arrays

    def _bf16_kernel(self, q, k: int):
        """Fused bf16 scan (ops/scan: bucket_topk, or exact_topk_sweep for
        scan_kernel="sweep")."""
        from hnsw_tpu_torch.ops.scan import (DEFAULT_BT, bucket_topk,
                                             exact_topk_sweep)

        vec, vsq = self._get_kernel_arrays()
        b = q.shape[0]
        # the bucket kernel runs at bt=1024; the sweep kernel's k live tiles
        # cap the reference at 512
        bt_cap = 2 * DEFAULT_BT if self._use_bucket() else DEFAULT_BT
        bt = min(bt_cap, max(round_up(b, 8), 8))
        b_pad = round_up(b, bt)
        qp = torch.zeros((b_pad, q.shape[1]), dtype=torch.bfloat16,
                         device=q.device)
        qp[:b] = q.to(torch.bfloat16)
        kern = bucket_topk if self._use_bucket() else exact_topk_sweep
        d, r = kern(vec, vsq, qp, self.corpus.n, k=k,
                    metric=self.corpus.metric, bt=bt)
        return d[:b], r[:b]

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     row_mask=None):
        from hnsw_tpu_torch.ops import scan

        q = self.corpus.pad_queries(queries)
        if row_mask is not None:
            mask = torch.zeros((self.corpus.n_pad,), dtype=torch.bool,
                               device=q.device)
            mask[: len(row_mask)] = torch.as_tensor(
                np.asarray(row_mask, bool), device=q.device)
            return exact_topk(
                self.corpus.vectors, self.corpus.sq_norms, q,
                k=k, n=self.corpus.n, metric=self.corpus.metric,
                tile=self.tile, precision="f32", row_mask=mask)
        if self.precision == "int8" and self.corpus.n > 0:
            # auto fetch k+6; int8_fetch=0 skips the re-rank (coarse-only)
            if self.int8_fetch is None:
                fetch = k + 6
            elif self.int8_fetch <= 0:
                fetch = 0
            else:
                fetch = max(self.int8_fetch, k)
            if self._on_card() and scan.supported(max(fetch, k)):
                return self._int8_kernel(q, k, fetch)
            # plain path (CPU, or k beyond the fused scan's range):
            # int8_fetch=0 keeps its coarse-only meaning; otherwise re-rank a
            # wider pool than the kernel path
            return int8_topk(*self._get_int8_arrays(), self.corpus.vectors,
                             self.corpus.sq_norms, q, self.corpus.n,
                             k=k,
                             fetch=0 if fetch <= 0 else max(fetch, 4 * k,
                                                            k + 32),
                             metric=self.corpus.metric)
        if (self.precision == "bf16" and scan.supported(k) and self._on_card()
                and self.corpus.n > 0):
            return self._bf16_kernel(q, k)
        return exact_topk(
            self.corpus.vectors, self.corpus.sq_norms, q,
            k=k, n=self.corpus.n, metric=self.corpus.metric,
            tile=self.tile, precision=self.precision,
        )

    def index_info(self) -> Dict[str, Any]:
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "precision": self.precision,
            "memory_mb": self.corpus.vectors.numel() * 4 / 1e6,
        }

    def to_state(self) -> Dict[str, Any]:
        return {"params": {"precision": self.precision, "tile": self.tile,
                           "scan_kernel": self.scan_kernel,
                           "int8_fetch": self.int8_fetch},
                "arrays": {}}

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "FlatIndex":
        p = state.get("params", {})
        f = p.get("int8_fetch")
        return cls(corpus, precision=p.get("precision", "f32"),
                   tile=int(p.get("tile", DEFAULT_TILE)),
                   scan_kernel=str(p.get("scan_kernel", "auto")),
                   int8_fetch=int(f) if f is not None else None)

    def search_filtered(self, query, k, predicate, mode=Mode.BALANCED,
                        overfetch: int = 3):
        """Native exact filtered search: the predicate becomes a row mask
        applied before top-k."""
        ids = self.corpus.ids if self.corpus.ids is not None else \
            np.arange(self.corpus.n)
        mask = np.fromiter((bool(predicate(i)) for i in ids), bool,
                           count=self.corpus.n)
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        d, r = self.search_batch(q, k, mode, row_mask=mask)
        return self._to_result(d[0].cpu().numpy(),
                               r[0].cpu().numpy()).to_dicts()


def build_flat_index(data, *, metric="cosine", ids=None, precision="f32",
                     scan_kernel="auto", int8_fetch=None, device=None,
                     **_ignored) -> FlatIndex:
    """Build from a host array [n, dim] or [id, vec] pairs, on the CUDA card
    unless device says otherwise."""
    from hnsw_tpu_torch.models.common import as_corpus
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    return FlatIndex(corpus, precision=precision, scan_kernel=scan_kernel,
                     int8_fetch=int8_fetch)

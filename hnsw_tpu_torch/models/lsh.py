"""Hybrid multi-probe LSH. Counterpart of ``hnsw_tpu/models/lsh.py``.

8 tables x 12 bits (4096 buckets), Gaussian random hyperplanes. The build
hashes every row on the host with numpy, exactly as the reference does, so
the buckets and the overflow accounting are the same in both packages:
buckets are fixed-capacity rows of an int32 table [T, 2^bits, cap], and a
row shed by a full bucket is counted (``overflow_dropped_slots``, and
``overflow_rows_unreachable`` for rows shed from every table). Search
hashes the queries on the device, probes each table's bucket and the
buckets one to ``radius`` bit flips away (the least confident bits first,
or bit positions in index order with ``flip_order="fixed"``), scores every
candidate row exactly and keeps the best k distinct rows.

A query gathers T x probes x cap candidate rows (3,584 at full width in
``precise``), so the batch is scored in chunks whose gathered block stays
under ``GATHER_BUDGET_BYTES``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import LSH_MODES, Mode
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.ops.distance import BIG, gather_score
from hnsw_tpu_torch.ops.topk import dedupe_ascending, top_k_ascending
from hnsw_tpu_torch.types import Corpus, Metric

NUM_TABLES = 8
NUM_BITS = 12       # 4096 buckets

# Bytes of gathered candidate rows [B, C, D_pad] f32 scored at once.
GATHER_BUDGET_BYTES = 1 << 30


def _probe_combos(probes: int, radius: int, nbits: int) -> List[Tuple[int, ...]]:
    """Static probe schedule: which margin-rank bits to flip per probe.
    Probe 0 flips nothing; then singles in margin order, then pairs, etc.,
    bounded by radius bits flipped at once."""
    combos: List[Tuple[int, ...]] = [()]
    for r in range(1, max(radius, 1) + 1):
        combos.extend(itertools.combinations(range(min(nbits, 8)), r))
    return combos[:probes]


def _query_buckets(q, proj, *, probes: int, radius: int,
                   flip_order: str = "margin"):
    """Bucket ids to probe. q: [B, D]; proj: [T, D, bits]. Returns int64
    [B, T, probes]. flip_order="fixed" flips bit positions in index order,
    the reference's query-independent schedule; "margin" flips the bits of
    least |score| first (a stable order, as the reference's argsort)."""
    nbits = proj.shape[-1]
    scores = torch.einsum("bd,tdh->bth", q, proj)              # [B, T, bits]
    bits = (scores > 0).long()
    weights = 1 << torch.arange(nbits, device=q.device)
    base = torch.sum(bits * weights, dim=-1)                   # [B, T]
    if flip_order == "fixed":
        margin_rank = torch.arange(nbits, device=q.device).expand(
            scores.shape)
    else:
        margin_rank = torch.sort(torch.abs(scores), dim=-1,
                                 stable=True).indices
    out = []
    for combo in _probe_combos(probes, radius, nbits):
        flip = torch.zeros_like(base)
        for rank in combo:
            flip = flip ^ (1 << margin_rank[:, :, rank])
        out.append(base ^ flip)
    return torch.stack(out, dim=-1)                            # [B, T, probes]


def _lsh_search(vectors, v_sq, proj, buckets, q, *, k: int, probes: int,
                radius: int, metric: Metric, flip_order: str = "margin"):
    """One chunk of queries: gather the probed buckets' rows, score them,
    over-fetch, drop duplicate rows and reselect."""
    b = q.shape[0]
    bucket_ids = _query_buckets(q, proj, probes=probes, radius=radius,
                                flip_order=flip_order)
    t = buckets.shape[0]
    table_idx = torch.arange(t, device=q.device)[None, :, None]
    cand = buckets[table_idx, bucket_ids].reshape(b, -1)       # [B, C]
    valid = cand >= 0
    d = gather_score(q, cand.clamp(min=0), vectors, v_sq, metric=metric,
                     valid=valid)
    fetch = min(max(4 * k, k + 16), d.shape[-1])
    d_f, sel = top_k_ascending(d, fetch)
    i_f = torch.where(d_f < BIG, torch.gather(cand, -1, sel), -1)
    dk, rk = dedupe_ascending(d_f, i_f, min(k, fetch))
    rk = torch.where(dk < BIG, rk, -1)
    if dk.shape[-1] < k:
        pad = k - dk.shape[-1]
        dk = torch.nn.functional.pad(dk, (0, pad), value=BIG)
        rk = torch.nn.functional.pad(rk, (0, pad), value=-1)
    return dk, rk


def lsh_search(vectors, v_sq, proj, buckets, q, *, k: int, probes: int,
               radius: int, metric: Metric, flip_order: str = "margin"):
    """_lsh_search over query chunks whose gathered candidate rows stay
    under GATHER_BUDGET_BYTES. Queries are independent, so the rows are
    those of one call over the whole batch."""
    metric = Metric.coerce(metric)
    t, _, cap = buckets.shape
    per_query = probes * t * cap * vectors.shape[1] * 4
    chunk = max(1, GATHER_BUDGET_BYTES // max(per_query, 1))
    parts = [_lsh_search(vectors, v_sq, proj, buckets, q[s: s + chunk],
                         k=k, probes=probes, radius=radius, metric=metric,
                         flip_order=flip_order)
             for s in range(0, q.shape[0], chunk)]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([r for _, r in parts]))


class HybridLSHIndex(ANNIndex):
    family = "hybrid_lsh"

    def __init__(self, corpus: Corpus, *, proj, buckets, num_tables: int,
                 num_bits: int, bucket_cap: int, seed: int = 42,
                 overflow: Optional[Dict[str, int]] = None):
        super().__init__(corpus)
        self.proj = proj            # [T, D_pad, bits] float32
        self.buckets = buckets      # int32 [T, 2^bits, cap] rows, -1 pad
        self.num_tables = num_tables
        self.num_bits = num_bits
        self.bucket_cap = bucket_cap
        self.seed = seed
        # bucket_cap overflow: dropped_slots = (row, table) placements shed;
        # rows_unreachable = rows shed from every table
        self.overflow = overflow or {"dropped_slots": 0, "rows_unreachable": 0}

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     num_probes: Optional[int] = None,
                     radius: Optional[int] = None,
                     flip_order: str = "margin"):
        q = self.corpus.pad_queries(queries)
        p_m, r_m = LSH_MODES[Mode.coerce(mode)]
        return lsh_search(
            self.corpus.vectors, self.corpus.sq_norms, self.proj,
            self.buckets, q, k=k, probes=num_probes or p_m,
            radius=radius or r_m, metric=self.corpus.metric,
            flip_order=flip_order)

    def index_info(self) -> Dict[str, Any]:
        occupancy = (self.buckets >= 0).sum(dim=-1).cpu().numpy()
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "num_tables": self.num_tables,
            "num_bits": self.num_bits,
            "num_buckets": self.buckets.shape[1],
            "bucket_cap": self.bucket_cap,
            "avg_bucket_occupancy": float(occupancy.mean()),
            "max_bucket_occupancy": int(occupancy.max()),
            "overflow_dropped_slots": int(self.overflow["dropped_slots"]),
            "overflow_rows_unreachable": int(
                self.overflow["rows_unreachable"]),
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "params": {"num_tables": self.num_tables,
                       "num_bits": self.num_bits,
                       "bucket_cap": self.bucket_cap, "seed": self.seed},
            "arrays": {"proj": self.proj.cpu().numpy(),
                       "buckets": self.buckets.cpu().numpy()},
        }

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "HybridLSHIndex":
        p, a = state["params"], state["arrays"]
        dev = corpus.device
        return cls(corpus,
                   proj=torch.from_numpy(np.array(a["proj"], np.float32))
                   .to(dev),
                   buckets=torch.from_numpy(np.array(a["buckets"], np.int32))
                   .to(dev),
                   num_tables=int(p["num_tables"]),
                   num_bits=int(p["num_bits"]),
                   bucket_cap=int(p["bucket_cap"]),
                   seed=int(p.get("seed", 42)))


def build_lsh_index(
    data,
    *,
    num_tables: int = NUM_TABLES,
    num_bits: int = NUM_BITS,
    bucket_cap: Optional[int] = None,
    metric="cosine",
    ids=None,
    seed: int = 42,
    device=None,
    **_ignored,
) -> HybridLSHIndex:
    """Hash on the host (numpy, the reference's arithmetic), then the
    bucket table on the CUDA card unless device says otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    n = corpus.n
    rng = np.random.default_rng(seed)
    # Gaussian hyperplanes over the real dims only (padding columns stay 0)
    proj = np.zeros((num_tables, corpus.d_pad, num_bits), np.float32)
    proj[:, : corpus.dim, :] = rng.standard_normal(
        (num_tables, corpus.dim, num_bits)).astype(np.float32)

    num_buckets = 1 << num_bits
    if bucket_cap is None:
        avg = max(n // num_buckets, 1)
        bucket_cap = int(min(max(8 * avg, 32), max(n, 32)))

    buckets = np.full((num_tables, num_buckets, bucket_cap), -1, np.int32)
    dropped_slots = 0
    stored = np.zeros(max(n, 1), bool)
    if n:
        scores = np.einsum("nd,tdh->tnh",
                           corpus.vectors[:n].cpu().numpy(), proj)
        hashes = (scores > 0).astype(np.int64) @ (1 << np.arange(num_bits))
        for ti in range(num_tables):
            h = hashes[ti]
            order = np.argsort(h, kind="stable")
            hs = h[order]
            first = np.searchsorted(hs, hs, side="left")
            pos = np.arange(n) - first
            keep = pos < bucket_cap
            buckets[ti, hs[keep], pos[keep]] = order[keep].astype(np.int32)
            dropped_slots += int((~keep).sum())
            stored[order[keep]] = True
    overflow = {"dropped_slots": dropped_slots,
                "rows_unreachable": int(n - stored[:n].sum()) if n else 0}

    dev = corpus.device
    return HybridLSHIndex(
        corpus, proj=torch.from_numpy(proj).to(dev),
        buckets=torch.from_numpy(buckets).to(dev),
        num_tables=num_tables, num_bits=num_bits, bucket_cap=bucket_cap,
        seed=seed, overflow=overflow)

"""Shared partition-scan machinery for IVF-FLAT and Lightning. Counterpart
of ``hnsw_tpu/models/_partition_scan.py``.

A cluster-sorted row permutation makes every partition a contiguous slab of
one table (``PartitionTable``). Two scans read it:

- ``scan_search``, the masked scan: every query scores every slab and keeps
  the rows of the clusters it probes. The reference runs it as a scan over
  clusters with a running stable top-k. Each cluster's valid rows are a
  contiguous run of the table, in cluster order, so that merge keeps the
  first kk rows by (distance, table position); here the table is scored in
  row tiles with the same stable merge, which is the same order.
- ``grouped_search``, the probe scan: queries are grouped by the clusters
  they probe and each slab is scored only against its group. The reference
  walks the clusters one by one; here groups of clusters run as one batched
  product each. Every pair slot is written by exactly one cluster, so the
  grouping does not change the answer.

Precision: f32 scans are f32 products (TF32 is off). Where the reference
scores in bf16 (a bf16-stored table, and the grouped scan unless
``precision="highest"``), the port takes f32 products of bf16-rounded
operands (``ops/distance.py:bf16_matmul``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hnsw_tpu_torch.ops.distance import (BIG, _dist_bc, as_bf16_f32,
                                         distances_from_dots)
from hnsw_tpu_torch.ops.topk import dedupe_ascending, top_k_ascending
from hnsw_tpu_torch.types import Corpus, Metric, round_up

# Table rows scored per step of the masked scan: bounds its [B, rows]
# distance tile.
SCAN_TILE = 32768
# Bytes of gathered queries, slabs and distances per batched step of the
# grouped scan: clusters are taken in groups that fit it.
GROUP_BUDGET_BYTES = 1 << 30


def _permute_slab(vectors, sq_norms, order, *, dtype, out_rows: int):
    """Cluster-sorted slab permute. The cast happens BEFORE the gather, so
    the full f32 gather never materializes for a bf16 table."""
    src = vectors.to(dtype)
    m = order.shape[0]
    permuted = torch.zeros((out_rows, vectors.shape[1]), dtype=dtype,
                           device=vectors.device)
    permuted[:m] = src[order]
    v_sq = torch.zeros((out_rows,), dtype=torch.float32,
                       device=vectors.device)
    v_sq[:m] = sq_norms[order]
    return permuted, v_sq


@dataclasses.dataclass
class PartitionTable:
    """Cluster-sorted slab layout over a corpus."""

    vectors: torch.Tensor    # [N_slab, D] permuted + cmax guard rows of zeros
    v_sq: torch.Tensor       # [N_slab]
    perm: torch.Tensor       # int32 [N_slab] original row per position (-1 pad)
    starts: torch.Tensor     # int32 [K]
    lens: torch.Tensor       # int32 [K]
    centroids: torch.Tensor  # [K, D]
    cmax: int                # max cluster size (padded slab width)
    k_parts: int

    @classmethod
    def build(cls, corpus: Corpus, assign: np.ndarray,
              centroids: Optional[np.ndarray] = None,
              secondary: Optional[np.ndarray] = None,
              dtype=torch.float32) -> "PartitionTable":
        """assign: int32 [n] primary cluster per original row (>= 0).
        secondary: optional int32 [n] spill cluster (-1 = none): the row is
        stored in both slabs, and the search merges drop the duplicate.
        centroids: [K, <= D_pad] host array, or None for the mean of each
        cluster's member rows. dtype: slab storage dtype (v_sq stays f32)."""
        n = corpus.n
        dev = corpus.device
        assign = np.asarray(assign[:n])
        if centroids is not None:
            k = int(centroids.shape[0])
        else:
            k = int(assign.max()) + 1 if n else 1

        rows = np.arange(n, dtype=np.int32)
        clusters = assign.astype(np.int64)
        if secondary is not None:
            sec = np.asarray(secondary[:n])
            keep = sec >= 0
            rows = np.concatenate([rows, rows[keep]])
            clusters = np.concatenate([clusters, sec[keep].astype(np.int64)])
        m = len(rows)

        sort = np.argsort(clusters, kind="stable")
        order = rows[sort]
        counts = np.bincount(clusters, minlength=k).astype(np.int32)
        starts = np.zeros(k, np.int32)
        starts[1:] = np.cumsum(counts)[:-1]
        cmax = int(round_up(max(int(counts.max()), 1), 8))

        # permute on the device: only the order crosses to it
        order_t = torch.from_numpy(order.astype(np.int64)).to(dev)
        permuted, v_sq = _permute_slab(corpus.vectors, corpus.sq_norms,
                                       order_t, dtype=dtype,
                                       out_rows=m + cmax)
        perm = np.full(m + cmax, -1, np.int32)
        perm[:m] = order

        if centroids is None:
            # mean of member rows per cluster: a one-hot product, a sum in
            # a fixed order
            a_t = torch.from_numpy(assign.astype(np.int64)).to(dev)
            onehot = torch.nn.functional.one_hot(a_t, k).float()
            sums = torch.matmul(onehot.T, corpus.vectors[:n])
            pc = torch.from_numpy(
                np.bincount(assign, minlength=k).astype(np.float32)).to(dev)
            cents = sums / torch.clamp(pc[:, None], min=1.0)
        else:
            c = np.zeros((k, corpus.d_pad), np.float32)
            c[:, : centroids.shape[1]] = centroids
            cents = torch.from_numpy(c).to(dev)

        return cls(
            vectors=permuted, v_sq=v_sq, perm=torch.from_numpy(perm).to(dev),
            starts=torch.from_numpy(starts).to(dev),
            lens=torch.from_numpy(counts).to(dev), centroids=cents,
            cmax=cmax, k_parts=k)

    def partition_sizes(self) -> np.ndarray:
        return self.lens.cpu().numpy()


def probe_mask_from_centroids(queries, centroids, *, num_probes: int,
                              metric: Metric):
    """Rank centroids per query (f32 products) and probe the closest
    num_probes, ties to the lower centroid id. Returns (mask bool [B, K],
    probe_ids int64 [B, P])."""
    c_sq = torch.sum(centroids * centroids, dim=-1)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    dots = torch.matmul(queries, centroids.T)
    dist = distances_from_dots(dots, q_sq, c_sq, Metric.coerce(metric))
    k = centroids.shape[0]
    _, probe_ids = top_k_ascending(dist, min(num_probes, k))
    mask = torch.zeros((queries.shape[0], k), dtype=torch.bool,
                       device=queries.device)
    mask.scatter_(1, probe_ids, True)
    return mask, probe_ids


def scan_search(table_vectors, table_v_sq, table_perm, starts, lens,
                probe_mask, queries, *, k: int, cmax: int, metric: Metric,
                dedup: bool = False):
    """Masked scan of every slab (dedup=True when the table has spill).
    The row tiles read the slabs as the table's first sum(lens) rows in
    cluster order, so starts must be the exclusive cumulative sum of lens
    and cmax at least max(lens); ValueError otherwise. Returns (dists
    [B, k], original rows [B, k] int32, -1 for missing)."""
    metric = Metric.coerce(metric)
    lens_h = lens.cpu().long()
    want = torch.cumsum(lens_h, 0) - lens_h
    if starts.shape != lens.shape or not torch.equal(starts.cpu().long(),
                                                     want):
        raise ValueError("starts is not the exclusive cumulative sum of "
                         "lens: the slabs must lie back to back in "
                         "cluster order")
    if lens_h.numel() and cmax < int(lens_h.max()):
        raise ValueError(f"cmax {cmax} < the largest slab "
                         f"{int(lens_h.max())}")
    b = queries.shape[0]
    dev = queries.device
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    # a bf16-stored table scores in bf16 (its values already carry bf16
    # rounding)
    lp = table_vectors.dtype == torch.bfloat16
    q_mat = as_bf16_f32(queries) if lp else queries
    # spilled tables hold a row in up to 2 slabs: carry 2k slots so that k
    # unique rows survive the dedupe
    kk = 2 * k if dedup else k
    m = int(lens_h.sum())
    owner = torch.repeat_interleave(
        torch.arange(lens.shape[0], device=dev), lens.long())

    best_d = torch.full((b, kk), BIG, dtype=torch.float32, device=dev)
    best_r = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
    for s in range(0, m, SCAN_TILE):
        e = min(s + SCAN_TILE, m)
        dots = torch.matmul(q_mat, table_vectors[s:e].float().T)
        dist = distances_from_dots(dots, q_sq, table_v_sq[s:e], metric)
        rows = table_perm[s:e]
        valid = probe_mask[:, owner[s:e]] & (rows >= 0)[None, :]
        dist = torch.where(valid, dist, BIG)
        d_all = torch.cat([best_d, dist], dim=-1)
        r_all = torch.cat([best_r, rows.expand(b, -1)], dim=-1)
        best_d, sel = top_k_ascending(d_all, kk)
        best_r = torch.gather(r_all, -1, sel)
    if dedup:
        best_d, best_r = dedupe_ascending(best_d, best_r, k)
    best_r = torch.where(best_d < BIG, best_r, -1)
    return best_d, best_r


def grouped_search(table_vectors, table_v_sq, table_perm, starts, lens,
                   probe_ids, queries, *, k: int, cmax: int, qcap: int,
                   metric: Metric, precision: str = "default"):
    """Probe scan grouped by cluster: each slab is scored only against the
    (at most qcap) queries that probe it. Pairs beyond qcap are dropped
    farthest-probe-first (pairs are ranked by probe order within a
    cluster), and counted. Returns (dists [B, k], rows [B, k] int32,
    dropped_pairs: a device scalar)."""
    metric = Metric.coerce(metric)
    b = queries.shape[0]
    p = probe_ids.shape[1]
    dev = queries.device
    n_clusters = starts.shape[0]
    kq = min(k, cmax)

    # pair order: by cluster, and within a cluster near probes first so
    # that qcap overflow sheds the farthest probes
    flat_c = probe_ids.reshape(-1).long()                    # [B*P], b-major
    rank = torch.arange(b * p, device=dev) % p
    order = torch.sort(flat_c * p + rank, stable=True).indices
    sc = flat_c[order]                                       # sorted clusters
    sb = order // p                                          # query per pair
    firsts = torch.searchsorted(sc, torch.arange(n_clusters, device=dev),
                                side="left")
    pos = torch.arange(b * p, device=dev) - firsts[sc]
    ok = pos < qcap
    lin = torch.where(ok, sc * qcap + pos, n_clusters * qcap)  # last = dump
    qslot = torch.full((n_clusters * qcap + 1,), -1, dtype=torch.long,
                       device=dev)
    qslot[lin] = sb
    qslot = qslot[:-1].reshape(n_clusters, qcap)
    pairslot = torch.full((n_clusters * qcap + 1,), b * p, dtype=torch.long,
                          device=dev)
    pairslot[lin] = order
    pairslot = pairslot[:-1].reshape(n_clusters, qcap)
    dropped = b * p - ok.sum()

    q_sq_all = torch.sum(queries.float() ** 2, dim=-1)       # [B]
    # a bf16-stored table forces the bf16 path whatever the precision asked
    lp = precision != "highest" or table_vectors.dtype == torch.bfloat16
    q_mat = as_bf16_f32(queries) if lp else queries.float()
    local = torch.arange(cmax, device=dev)

    out_d = torch.full((b * p + 1, kq), BIG, dtype=torch.float32, device=dev)
    out_r = torch.full((b * p + 1, kq), -1, dtype=torch.int32, device=dev)
    d_pad = table_vectors.shape[1]
    per_cluster = 4 * (qcap * d_pad + 2 * cmax * d_pad + 3 * qcap * cmax)
    group = max(1, min(n_clusters, GROUP_BUDGET_BYTES // per_cluster))
    for c0 in range(0, n_clusters, group):
        c1 = min(c0 + group, n_clusters)
        qi = qslot[c0:c1]                                    # [G, qcap]
        qg = q_mat[qi.clamp(min=0)]                          # [G, qcap, D]
        q_sq = q_sq_all[qi.clamp(min=0)]
        idx = starts[c0:c1, None].long() + local             # [G, cmax]
        slab = table_vectors[idx].float()                    # [G, cmax, D]
        if lp:
            slab = as_bf16_f32(slab)
        slab_rows = table_perm[idx]
        valid = ((local[None, :] < lens[c0:c1, None])
                 & (slab_rows >= 0))[:, None, :] & (qi >= 0)[:, :, None]
        dots = torch.bmm(qg, slab.transpose(1, 2))           # [G, qcap, cmax]
        dist = _dist_bc(dots, q_sq[:, :, None], table_v_sq[idx][:, None, :],
                        metric)
        dist = torch.where(valid, dist, BIG)
        dloc, iloc = top_k_ascending(dist, kq)               # [G, qcap, kq]
        rows = torch.gather(slab_rows[:, None, :].expand(-1, qcap, -1), -1,
                            iloc)
        rows = torch.where(dloc < BIG, rows, -1)
        ps = pairslot[c0:c1].reshape(-1)
        out_d[ps] = dloc.reshape(-1, kq)
        out_r[ps] = rows.reshape(-1, kq)

    od = out_d[:-1].reshape(b, p * kq)
    orows = out_r[:-1].reshape(b, p * kq)
    if p * kq < k:      # fewer candidates than requested (tiny tables)
        od = torch.nn.functional.pad(od, (0, k - p * kq), value=BIG)
        orows = torch.nn.functional.pad(orows, (0, k - p * kq), value=-1)
    # dedupe: a spilled row appears once per probed slab
    dk, rk = dedupe_ascending(od, orows, k)
    rk = torch.where(dk < BIG, rk, -1)
    return dk, rk, dropped


def default_qcap(b: int, p: int, k_parts: int) -> int:
    """Per-cluster query-group capacity: ~4x the uniform expectation,
    power-of-two bucketed, never above B (nor below 8)."""
    avg = max(1, (b * p + k_parts - 1) // k_parts)
    cap = 1
    while cap < 4 * avg:
        cap *= 2
    return max(8, min(cap, b))

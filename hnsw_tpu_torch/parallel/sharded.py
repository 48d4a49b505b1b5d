"""Sharded search over a device mesh. Counterpart of
``hnsw_tpu/parallel/sharded.py``.

Two shardings, as in the reference:

* corpus rows (``ShardedFlatIndex``, and ``ShardedIVFFlat`` over clusters):
  each device scores its own slab and keeps a local top-k; the merge is an
  all-gather of the [B, k] candidates in the reference's order (shard-major,
  then local rank) and a stable reselect on the mesh's first device;
* partitions (``ShardedPartitionedHNSW``): each device beam-searches its
  local partitions, then the same merge.

The reference runs each per-device body under ``jax.shard_map``; here one
process runs it once per mesh entry (``parallel/mesh.py``). Products are f32
``torch.matmul`` (TF32 is off): the reference computes them outside any
Pallas kernel, so the port's twin is the plain product too.
"""

from __future__ import annotations

from typing import Optional

import torch

from hnsw_tpu_torch.config import (IVF_FLAT_PROBES, Mode,
                                   adaptive_k_per_partition, ef_for)
from hnsw_tpu_torch.models._partition_scan import (SCAN_TILE,
                                                   probe_mask_from_centroids)
from hnsw_tpu_torch.models.hnsw.search import hnsw_search_batch
from hnsw_tpu_torch.ops.distance import BIG, distances_from_dots
from hnsw_tpu_torch.ops.topk import dedupe_ascending, top_k_ascending
from hnsw_tpu_torch.parallel.mesh import (Mesh, all_gather, as_shards,
                                          make_mesh, psum, shard)
from hnsw_tpu_torch.types import Corpus, Metric, round_up


def _merge(mesh: Mesh, d_loc, r_loc, k: int, *, dedup: bool = False):
    """All-gather every device's [B, kk] candidates in shard-major order,
    reselect the k best (stable; deduplicated by row for spilled tables),
    and pad with (1e30, -1) when fewer than k exist."""
    all_d = all_gather(mesh, d_loc)                  # [D, B, kk]
    all_r = all_gather(mesh, r_loc)
    b = all_d.shape[1]
    all_d = all_d.transpose(0, 1).reshape(b, -1)
    all_r = all_r.transpose(0, 1).reshape(b, -1)
    kk = min(k, all_d.shape[-1])
    if dedup:
        dk, rk = dedupe_ascending(all_d, all_r, kk)
    else:
        dk, sel = top_k_ascending(all_d, kk)
        rk = torch.gather(all_r, -1, sel)
    rk = torch.where(dk < BIG, rk, -1)
    if kk < k:
        dk = torch.nn.functional.pad(dk, (0, k - kk), value=1e30)
        rk = torch.nn.functional.pad(rk, (0, k - kk), value=-1)
    return dk, rk


# ---------------------------------------------------------------------------
# corpus-row sharded exact search
# ---------------------------------------------------------------------------

def _local_exact(vectors_l, v_sq_l, rows_l, queries, *, k, metric):
    """One device's slab: f32 scores, padding (rows -1) masked, local
    top-k. rows_l carries global row ids."""
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    dots = torch.matmul(queries, vectors_l.T)
    dist = distances_from_dots(dots, q_sq, v_sq_l, metric)
    dist = torch.where((rows_l >= 0)[None, :], dist, BIG)
    d_loc, pos = top_k_ascending(dist, min(k, vectors_l.shape[0]))
    return d_loc, torch.where(d_loc < BIG, rows_l[pos], -1)


def sharded_exact_topk(mesh: Mesh, vectors, v_sq, rows, queries, *,
                       k: int, metric: Metric, axis: Optional[str] = None):
    """vectors / v_sq / rows sharded on dim 0 over the mesh (lists of
    per-device pieces, or tensors split evenly); queries replicated.
    Returns (dists [B, k], global rows [B, k]) on the mesh's first device.
    The mesh has one axis here, so `axis` only names it."""
    metric = Metric.coerce(metric)
    parts = zip(as_shards(mesh, vectors), as_shards(mesh, v_sq),
                as_shards(mesh, rows), mesh.device_list)
    d_loc, r_loc = zip(*[_local_exact(v, s, r, queries.to(dev), k=k,
                                      metric=metric)
                         for v, s, r, dev in parts])
    return _merge(mesh, d_loc, r_loc, k)


class ShardedFlatIndex:
    """Exact search with the corpus rows split over the mesh."""

    def __init__(self, corpus: Corpus, mesh: Optional[Mesh] = None):
        self.corpus = corpus
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        d = self.mesh.size
        n_pad = round_up(corpus.n_pad, d * 8)
        grow = n_pad - corpus.n_pad
        dev = corpus.device
        rows = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        rows[: corpus.n] = torch.arange(corpus.n, dtype=torch.int32,
                                        device=dev)
        self.vectors = shard(self.mesh, torch.nn.functional.pad(
            corpus.vectors, (0, 0, 0, grow)))
        self.v_sq = shard(self.mesh, torch.nn.functional.pad(
            corpus.sq_norms, (0, grow)))
        self.rows = shard(self.mesh, rows)

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED):
        q = self.corpus.pad_queries(queries)
        return sharded_exact_topk(self.mesh, self.vectors, self.v_sq,
                                  self.rows, q, k=k,
                                  metric=self.corpus.metric, axis=self.axis)


# ---------------------------------------------------------------------------
# data-parallel k-means step
# ---------------------------------------------------------------------------

def _local_lloyd(vectors_l, v_sq_l, valid_l, centroids, *, metric):
    """Local assignment and one-hot partial sums of one Lloyd iteration."""
    c_sq = torch.sum(centroids * centroids, dim=-1)
    dots = torch.matmul(vectors_l, centroids.T)
    dist = distances_from_dots(dots, v_sq_l[:, None], c_sq[None, :], metric)
    assign = torch.argmin(dist, dim=-1)                  # first minimum
    onehot = torch.nn.functional.one_hot(assign, centroids.shape[0]).float()
    onehot = onehot * valid_l.float()[:, None]
    return (torch.sum(onehot, dim=0), torch.matmul(onehot.T, vectors_l),
            torch.where(valid_l.bool(), assign.to(torch.int32), -1))


def sharded_lloyd_step(mesh: Mesh, vectors, v_sq, valid, centroids, *,
                       metric: Metric, axis: Optional[str] = None):
    """One Lloyd iteration with the corpus rows sharded: vectors / v_sq /
    valid sharded on dim 0 (pieces or tensors), centroids replicated.
    Counts and sums are psum-merged. Returns (new centroids on the mesh's
    first device, the per-device assignments: a list of int32 pieces, -1
    on invalid rows)."""
    metric = Metric.coerce(metric)
    parts = zip(as_shards(mesh, vectors), as_shards(mesh, v_sq),
                as_shards(mesh, valid), mesh.device_list)
    counts, sums, assign = zip(*[
        _local_lloyd(v, s, ok, centroids.to(dev).float(), metric=metric)
        for v, s, ok, dev in parts])
    counts, sums = psum(mesh, counts), psum(mesh, sums)
    cents = centroids.to(mesh.first).float()
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1.0), cents)
    return new, list(assign)


# ---------------------------------------------------------------------------
# cluster-sharded IVF / Lightning slab scan
# ---------------------------------------------------------------------------

def _local_ivf(slabs_l, slab_sq_l, slab_rows_l, lens_l, mask_l, queries, *,
               kk, metric):
    """One device's clusters ([K_loc, cmax, D] slabs) against the whole
    batch, keeping a running stable top-kk. The reference scans the
    clusters one by one; scoring groups of them at once in cluster order,
    with the same stable merge, keeps the first kk candidates by
    (distance, cluster, slab position) all the same."""
    b = queries.shape[0]
    k_loc, cmax, dim = slabs_l.shape
    dev = queries.device
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    local = torch.arange(cmax, device=dev)
    valid = (local[None, :] < lens_l[:, None]) & (slab_rows_l >= 0)
    best_d = torch.full((b, kk), BIG, dtype=torch.float32, device=dev)
    best_r = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
    group = max(1, SCAN_TILE // cmax)     # bounds the [B, rows] tile
    for c0 in range(0, k_loc, group):
        c1 = min(c0 + group, k_loc)
        dots = torch.matmul(queries, slabs_l[c0:c1].reshape(-1, dim).T)
        dist = distances_from_dots(dots, q_sq,
                                   slab_sq_l[c0:c1].reshape(-1), metric)
        keep = (valid[c0:c1][None] & mask_l[:, c0:c1, None]).reshape(b, -1)
        dist = torch.where(keep, dist, BIG)
        d_all = torch.cat([best_d, dist], dim=-1)
        r_all = torch.cat([best_r, slab_rows_l[c0:c1].reshape(1, -1)
                           .expand(b, -1)], dim=-1)
        best_d, sel = top_k_ascending(d_all, kk)
        best_r = torch.gather(r_all, -1, sel)
    return best_d, best_r


class ShardedIVFFlat:
    """An IVF-FLAT (or Lightning) index with its cluster axis laid over the
    mesh: each device owns K/D clusters as [K_loc, cmax, D] f32 slabs; a
    search probes the centroids (on the first device), scans the local
    slabs, and merges the candidates."""

    def __init__(self, index, mesh: Optional[Mesh] = None):
        t = index.table
        self.inner = index
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        d = self.mesh.size
        self.k_pad = round_up(t.k_parts, d)
        dev = t.vectors.device
        # slab c is table rows starts[c] .. starts[c] + cmax (the table ends
        # in cmax guard rows, so every window lies inside it), cut at lens
        idx = t.starts.long()[:, None] + torch.arange(t.cmax, device=dev)
        live = torch.arange(t.cmax, device=dev)[None, :] < t.lens[:, None]
        grow = self.k_pad - t.k_parts
        slabs = torch.where(live[:, :, None], t.vectors[idx].float(), 0.0)
        slab_sq = torch.where(live, t.v_sq[idx], 0.0)
        slab_rows = torch.where(live, t.perm[idx], -1)
        pad = torch.nn.functional.pad
        self.slabs = shard(self.mesh, pad(slabs, (0, 0, 0, 0, 0, grow)))
        self.slab_sq = shard(self.mesh, pad(slab_sq, (0, 0, 0, grow)))
        self.slab_rows = shard(self.mesh, pad(slab_rows, (0, 0, 0, grow),
                                              value=-1))
        self.lens = shard(self.mesh, pad(t.lens, (0, grow)))

    @property
    def corpus(self):
        return self.inner.corpus

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     num_probes: Optional[int] = None):
        q = self.corpus.pad_queries(queries)
        t = self.inner.table
        if num_probes is None:
            num_probes = IVF_FLAT_PROBES[Mode.coerce(mode)]
        mask, _ = probe_mask_from_centroids(
            q, t.centroids, num_probes=min(num_probes, t.k_parts),
            metric=self.corpus.metric)
        # padding clusters are never probed
        mask = torch.nn.functional.pad(mask, (0, self.k_pad - t.k_parts))
        # spilled tables store a row in up to two slabs (maybe on two
        # devices): carry 2k locally so that k unique rows survive
        spill = bool(getattr(self.inner, "spill", 0))
        kk = 2 * k if spill else k
        masks = torch.chunk(mask, self.mesh.size, dim=1)
        d_loc, r_loc = zip(*[
            _local_ivf(s, sq, r, ln, m.to(dev), q.to(dev), kk=kk,
                       metric=self.corpus.metric)
            for s, sq, r, ln, m, dev in zip(
                self.slabs, self.slab_sq, self.slab_rows, self.lens, masks,
                self.mesh.device_list)])
        return _merge(self.mesh, d_loc, r_loc, k, dedup=True)


# ---------------------------------------------------------------------------
# partition-sharded HNSW
# ---------------------------------------------------------------------------

def _local_partitions(vecs_p, v_sq_p, rows_p, adj0_p, adju_p, entries_p,
                      queries, *, kpp, ef, metric):
    """One device's P_loc partitions searched as ONE hnsw_search_batch over
    their block-diagonal stack: partition p's ids are offset by p * S and
    each query is repeated once per partition (partition-major), entered at
    that partition's entry. Edges never cross partitions and every virtual
    query's beam is its own, and the hop bound depends only on ef and
    expand, so the rows are those of the reference's vmap over partitions.
    Returns the local candidates [B, P_loc * kpp] as global rows."""
    p_loc, s = rows_p.shape
    b = queries.shape[0]
    dev = queries.device
    off = (torch.arange(p_loc, device=dev, dtype=torch.int32) * s)
    adj0 = torch.where(adj0_p >= 0, adj0_p + off[:, None, None], -1)
    adju = torch.where(adju_p >= 0, adju_p + off[:, None, None, None], -1)
    entries = torch.where(entries_p >= 0, entries_p + off, -1)
    d_v, r_v = hnsw_search_batch(
        vecs_p.reshape(p_loc * s, -1), v_sq_p.reshape(-1),
        adj0.reshape(p_loc * s, adj0.shape[-1]),
        adju.transpose(0, 1).reshape(adju.shape[1], p_loc * s,
                                     adju.shape[-1]),
        entries.repeat_interleave(b), queries.repeat(p_loc, 1),
        k=kpp, ef=ef, metric=metric)
    g_v = torch.where(r_v >= 0, rows_p.reshape(-1)[r_v.clamp(min=0).long()],
                      -1)
    # [P_loc * B, kpp] partition-major -> [B, P_loc * kpp]
    d_loc = d_v.reshape(p_loc, b, kpp).transpose(0, 1).reshape(b, -1)
    g_loc = g_v.reshape(p_loc, b, kpp).transpose(0, 1).reshape(b, -1)
    return d_loc, g_loc


def stacked_vectors(corpus: Corpus, rows_p):
    """([P, S, D], [P, S]) partition-stacked vectors and norms gathered on
    the corpus's device (rows -1 give zero rows)."""
    ok = rows_p >= 0
    r = rows_p.clamp(min=0).long()
    return (torch.where(ok[:, :, None], corpus.vectors[r], 0.0),
            torch.where(ok, corpus.sq_norms[r], 0.0))


class ShardedPartitionedHNSW:
    """A PartitionedHNSWIndex with its partition axis laid over the mesh
    (the number of partitions must divide over it)."""

    def __init__(self, index, mesh: Optional[Mesh] = None):
        self.inner = index
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        d = self.mesh.size
        if index.num_partitions % d != 0:
            raise ValueError(
                f"num_partitions {index.num_partitions} not divisible by "
                f"mesh size {d}")
        vecs, v_sq = index.vectors_p, index.v_sq_p
        if vecs is None or v_sq is None:
            # formed once, here, from the corpus rows
            vecs, v_sq = stacked_vectors(index.corpus, index.rows_p)
        self.vectors_p = shard(self.mesh, vecs)
        self.v_sq_p = shard(self.mesh, v_sq)
        self.rows_p = shard(self.mesh, index.rows_p)
        self.adj0_p = shard(self.mesh, index.adj0_p)
        self.adj_upper_p = shard(self.mesh, index.adj_upper_p)
        self.entries_p = shard(self.mesh, index.entries_p)

    @property
    def corpus(self):
        return self.inner.corpus

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     ef: Optional[int] = None,
                     k_per_partition: Optional[int] = None):
        q = self.corpus.pad_queries(queries)
        mode = Mode.coerce(mode)
        if k_per_partition is None:
            k_per_partition = k if mode == Mode.PRECISE else \
                min(k, adaptive_k_per_partition(self.inner.num_partitions, k))
        ef = ef if ef is not None else ef_for(mode, k_per_partition)
        d_loc, g_loc = zip(*[
            _local_partitions(*parts, q.to(dev), kpp=k_per_partition, ef=ef,
                              metric=self.corpus.metric)
            for *parts, dev in zip(
                self.vectors_p, self.v_sq_p, self.rows_p, self.adj0_p,
                self.adj_upper_p, self.entries_p, self.mesh.device_list)])
        return _merge(self.mesh, d_loc, g_loc, k)

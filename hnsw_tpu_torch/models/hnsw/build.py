"""HNSW construction from exact candidate sets, and the incremental wave
insert. Counterpart of ``hnsw_tpu/models/hnsw/build.py`` for N <= LARGE_N.

For each layer the builder computes the EXACT kNN candidate set of every node
(tiled product + top-k), applies the neighbour-selection heuristic (keep a
candidate iff it is closer to the node than to any already-selected
neighbour, then re-add pruned candidates to fill spare slots), and
symmetrizes with a reverse-edge pass + heuristic re-prune. Upper layers
repeat the recipe on the level-l subset; layers of at most HOST_LAYER_MAX
nodes are built in numpy. Connectivity repair (repair.py) bridges the
components an exact-kNN graph leaves on clustered data. ``insert_wave``
connects a wave of appended rows into an existing graph (the add path of
``HNSWIndex.add_batch``).

This path runs no TPU kernel in the reference: it is plain tensor code
(products, sorts, a heuristic scan), and so is the port. The reference's
``lax.scan`` loops (heuristic over candidates, passes over node tiles)
become Python loops; its one-key ``lax.sort`` calls carrying payloads become
stable sorts plus gathers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from hnsw_tpu_torch.models.hnsw.graph import NONE, HNSWGraph, assign_levels
from hnsw_tpu_torch.ops.distance import (BIG, as_bf16_f32, distances_from_dots,
                                         gather_score)
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Corpus, Metric

# Query-tile row count for build passes: bounds the [QT, N] score block.
BUILD_TILE = 1024
# layers at or below this size build entirely on host
HOST_LAYER_MAX = 512
# the reference's bucketed large-N builder (build_large.py) takes over above
# this many rows; it is not ported yet
LARGE_N = 150_000


class BuildInterrupted(Exception):
    """Raised when a should_continue callback returns False mid-build."""


# ---------------------------------------------------------------------------
# neighbor-selection heuristic, vectorized over nodes
# ---------------------------------------------------------------------------

def _sort_with(key, *payloads):
    """Stable ascending sort of key along the last axis carrying payloads
    (the reference's one-key variadic ``lax.sort``)."""
    ks, order = torch.sort(key, dim=-1, stable=True)
    return (ks,) + tuple(torch.gather(p, -1, order) for p in payloads)


def _heuristic_impl(cand_ids, cand_d, pair_d, *, cap, keep_pruned=True,
                    return_d=False):
    """Returns sel_ids [T, cap] (-1 padded), plus the selected candidates'
    distances when return_d. Candidate j is selected iff it is closer to the
    node than to every already-selected candidate; pruned candidates refill
    spare slots in ascending order when keep_pruned."""
    t, kk = cand_ids.shape
    valid = cand_ids >= 0
    sel_mask = torch.zeros((t, kk), dtype=torch.bool, device=cand_ids.device)
    for j in range(kk):
        dmin = torch.amin(torch.where(sel_mask, pair_d[:, j, :], BIG), dim=-1)
        count = torch.sum(sel_mask, dim=-1)
        sel_mask[:, j] = (cand_d[:, j] < dmin) & (count < cap) & valid[:, j]

    order = torch.arange(kk, dtype=torch.float32, device=cand_ids.device)[None]
    key = torch.where(sel_mask, order, order + kk)      # selected first
    if not keep_pruned:
        key = torch.where(sel_mask, key, 4.0 * kk)
    key = torch.where(valid, key, 8.0 * kk)             # invalid last
    key_s, ids_s, d_s = _sort_with(key, cand_ids, cand_d)
    keep = key_s[:, :cap] < 4.0 * kk
    out = torch.where(keep, ids_s[:, :cap], -1)
    out_d = torch.where(keep, d_s[:, :cap], BIG)
    if kk < cap:
        out = torch.nn.functional.pad(out, (0, cap - kk), value=-1)
        out_d = torch.nn.functional.pad(out_d, (0, cap - kk), value=BIG)
    return (out, out_d) if return_d else out


def _pairwise_among_impl(vecs, sq, metric: Metric, precision="highest"):
    """Distances among gathered candidates. vecs: [T, K, D], sq: [T, K].
    Returns [T, K, K]."""
    if precision == "bf16":
        vb = as_bf16_f32(vecs)
        dots = torch.bmm(vb, vb.transpose(1, 2))
    else:
        vf = vecs.float()
        dots = torch.bmm(vf, vf.transpose(1, 2))
    if metric == Metric.COSINE:
        denom = torch.sqrt(torch.clamp(sq[:, :, None] * sq[:, None, :],
                                       min=1e-12))
        return 1.0 - dots / denom
    if metric == Metric.EUCLIDEAN:
        return torch.sqrt(torch.clamp(
            sq[:, :, None] + sq[:, None, :] - 2 * dots, min=0.0))
    if metric == Metric.DOT:
        return -dots
    raise ValueError(metric)


def _select_impl(node_vecs, cand_ids, vectors, v_sq, self_ids, *, cap,
                 metric, keep_pruned=True, precision="highest"):
    """Dedupe candidates (later duplicates and self dropped), score them
    against the node, stable-sort ascending, pairwise-score, and select cap
    with the heuristic. node_vecs [T, D], cand_ids [T, C] int32 (-1
    invalid, may repeat), self_ids [T]. Returns [T, cap] int32."""
    t, c = cand_ids.shape
    dev = cand_ids.device
    valid = (cand_ids >= 0) & (cand_ids != self_ids[:, None])
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup = torch.any(eq & earlier & valid[:, None, :], dim=-1)
    valid = valid & ~dup

    d = gather_score(node_vecs, torch.clamp(cand_ids, min=0), vectors, v_sq,
                     metric=metric, valid=valid)
    d_sorted, ids_sorted = _sort_with(d, cand_ids)
    ids_sorted = torch.where(d_sorted < BIG, ids_sorted, -1)
    rows = torch.clamp(ids_sorted, min=0)
    pair_d = _pairwise_among_impl(vectors[rows], v_sq[rows], metric, precision)
    return _heuristic_impl(ids_sorted, d_sorted, pair_d, cap=cap,
                           keep_pruned=keep_pruned)


def select_from_candidates(node_vecs, cand_ids, vectors, v_sq, self_ids, *,
                           cap: int, metric: Metric,
                           keep_pruned: bool = True):
    """Full selection pipeline for one node tile (see _select_impl)."""
    return _select_impl(node_vecs, cand_ids, vectors, v_sq, self_ids,
                        cap=cap, metric=Metric.coerce(metric),
                        keep_pruned=keep_pruned)


# ---------------------------------------------------------------------------
# reverse-edge collection (host, vectorized numpy)
# ---------------------------------------------------------------------------

def reverse_candidates(adj: np.ndarray, n: int, rev_cap: int) -> np.ndarray:
    """For forward adjacency [ns, cap], collect up to rev_cap reverse sources
    per destination, in forward-slot order. Returns [n, rev_cap] int32."""
    ns, cap = adj.shape
    src = np.repeat(np.arange(ns, dtype=np.int32), cap)
    dst = adj.reshape(-1)
    slot = np.tile(np.arange(cap, dtype=np.int32), ns)
    keep = dst >= 0
    src, dst, slot = src[keep], dst[keep], slot[keep]
    order = np.lexsort((slot, dst))
    src, dst = src[order], dst[order]
    first = np.searchsorted(dst, dst, side="left")
    pos = np.arange(len(dst)) - first
    keep = pos < rev_cap
    rev = np.full((n, rev_cap), NONE, np.int32)
    rev[dst[keep], pos[keep]] = src[keep]
    return rev


# ---------------------------------------------------------------------------
# host small-layer path (numpy, as in the reference)
# ---------------------------------------------------------------------------

def _host_distances(x: np.ndarray, metric: Metric) -> np.ndarray:
    sq = (x * x).sum(axis=1)
    dots = x @ x.T
    if metric == Metric.COSINE:
        denom = np.sqrt(np.maximum(sq[:, None] * sq[None, :], 1e-12))
        return (1.0 - dots / denom).astype(np.float32)
    if metric == Metric.EUCLIDEAN:
        return np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * dots, 0.0)
                       ).astype(np.float32)
    return (-dots).astype(np.float32)


def _host_heuristic(cand_ids, cand_d, pair_d, cap):
    """Numpy twin of the heuristic: vectorized over nodes, K-step scan."""
    t, kk = cand_ids.shape
    valid = cand_ids >= 0
    sel = np.zeros((t, kk), bool)
    for j in range(kk):
        masked = np.where(sel, pair_d[:, j, :], np.inf)
        dmin = masked.min(axis=1)
        good = (cand_d[:, j] < dmin) & (sel.sum(axis=1) < cap) & valid[:, j]
        sel[:, j] = good
    order = np.arange(kk, dtype=np.float32)[None, :]
    key = np.where(sel, order, order + kk)
    key = np.where(valid, key, 8.0 * kk)
    pos = np.argsort(key, axis=1)[:, :cap]
    out = np.take_along_axis(cand_ids, pos, axis=1)
    out_key = np.take_along_axis(key, pos, axis=1)
    out = np.where(out_key < 4.0 * kk, out, NONE).astype(np.int32)
    if kk < cap:
        out = np.pad(out, ((0, 0), (0, cap - kk)), constant_values=NONE)
    return out


def _build_layer_host(x: np.ndarray, *, cap: int, k_cand: int,
                      metric: Metric) -> np.ndarray:
    """Whole-layer build in numpy for small layers."""
    ns = x.shape[0]
    dist = _host_distances(x, metric)
    np.fill_diagonal(dist, np.inf)
    kq = min(k_cand, ns - 1)
    cand = np.argsort(dist, axis=1, kind="stable")[:, :kq].astype(np.int32)
    cand_d = np.take_along_axis(dist, cand, axis=1)
    pair_d = dist[cand[:, :, None], cand[:, None, :]]
    fwd = _host_heuristic(cand, cand_d, pair_d, cap)

    rev = reverse_candidates(fwd, ns, rev_cap=cap)
    both = np.concatenate([fwd, rev], axis=1)
    # dedupe + drop self, re-sort ascending, re-run heuristic
    c2 = both.shape[1]
    rows = np.arange(ns)
    d2 = np.where(both >= 0, dist[rows[:, None], np.maximum(both, 0)], np.inf)
    d2 = np.where(both == rows[:, None], np.inf, d2)
    for j in range(1, c2):
        dup = (both[:, j][:, None] == both[:, :j]).any(axis=1) & (both[:, j] >= 0)
        d2[dup, j] = np.inf
    pos = np.argsort(d2, axis=1, kind="stable")[:, :c2]
    ids_sorted = np.where(np.take_along_axis(d2, pos, axis=1) < np.inf,
                          np.take_along_axis(both, pos, axis=1), NONE)
    d_sorted = np.take_along_axis(d2, pos, axis=1).astype(np.float32)
    d_sorted[~np.isfinite(d_sorted)] = 1e30
    pair2 = dist[np.maximum(ids_sorted, 0)[:, :, None],
                 np.maximum(ids_sorted, 0)[:, None, :]]
    return _host_heuristic(ids_sorted.astype(np.int32), d_sorted, pair2, cap)


def _pow2_at_least(x: int, floor: int) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# device layer build
# ---------------------------------------------------------------------------

def _select_sorted_impl(cand_ids, cand_d, sub_lp, sub_sq, *, cap, metric,
                        precision="bf16"):
    """Selection for candidates that are already exactly scored and
    ascending: one pairwise gather + the heuristic."""
    rows = torch.clamp(cand_ids, min=0)
    pair_d = _pairwise_among_impl(sub_lp[rows], sub_sq[rows], metric,
                                  precision)
    return _heuristic_impl(cand_ids, cand_d, pair_d, cap=cap, return_d=True)


def _reverse_device(fwd, fwd_d, rev_cap: int):
    """Device-side reverse-edge collection carrying each edge's (symmetric)
    distance. fwd: [ns_pad, cap] -> (rev [ns_pad, rev_cap],
    rev_d [ns_pad, rev_cap]). Invalid edges all write the dump cell
    (ns_pad, rev_cap), which is sliced away, so the unordered duplicate
    writes there are harmless."""
    ns_pad, cap = fwd.shape
    e = ns_pad * cap
    dev = fwd.device
    dst = fwd.reshape(-1).long()
    src = torch.arange(ns_pad, device=dev).repeat_interleave(cap)
    slot = torch.arange(cap, device=dev).repeat(ns_pad)
    # stable order by (dst, slot); invalid edges sort last
    key = torch.where(dst >= 0, dst * cap + slot, e)
    order = torch.argsort(key, stable=True)
    dst_s = dst[order]
    src_s = src[order]
    d_s = fwd_d.reshape(-1)[order]
    # the -1 tail is mapped above every real id so the searched array is
    # sorted (a binary search over the raw -1 tail can miss a group start)
    dst_key = torch.where(dst_s >= 0, dst_s, ns_pad)
    first = torch.searchsorted(dst_key, dst_key, side="left")
    pos = torch.arange(e, device=dev) - first
    ok = (dst_s >= 0) & (pos < rev_cap)
    row = torch.where(ok, dst_s, ns_pad)
    col = torch.where(ok, pos, rev_cap)
    rev = torch.full((ns_pad + 1, rev_cap + 1), NONE, dtype=torch.int32,
                     device=dev)
    rev[row, col] = src_s.to(torch.int32)
    rev_d = torch.full((ns_pad + 1, rev_cap + 1), BIG, dtype=torch.float32,
                       device=dev)
    rev_d[row, col] = d_s
    return rev[:ns_pad, :rev_cap], rev_d[:ns_pad, :rev_cap]


def _layer_fused(sub, n, *, cap: int, kq: int, metric: Metric, tile: int,
                 precision: str = "highest"):
    """Layer build: forward pass (tile scan: exact scores -> top-kq ->
    heuristic), device reverse edges, re-prune pass. precision="bf16" scores
    with bf16 operands and f32 products."""
    ns_pad, d = sub.shape
    dev = sub.device
    n = int(n)
    sub_sq = torch.sum(sub * sub, dim=-1)
    num_tiles = ns_pad // tile
    row_valid = torch.arange(ns_pad, device=dev)[None, :] < n
    sub_lp = as_bf16_f32(sub) if precision == "bf16" else sub
    cols = torch.arange(ns_pad, device=dev)[None, :]

    fwd_t, fwd_dt = [], []
    for ti in range(num_tiles):
        start = ti * tile
        q = sub[start:start + tile]
        if precision == "bf16":
            dots = torch.matmul(as_bf16_f32(q), sub_lp.T)
        else:
            dots = torch.matmul(q, sub.T)
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        dist = distances_from_dots(dots, q_sq, sub_sq, metric)
        dist = torch.where(row_valid, dist, BIG)
        selfi = start + torch.arange(tile, device=dev)
        # mask self before top-k: the kq candidates are then all real,
        # exactly scored, ascending and unique
        dist = torch.where(cols == selfi[:, None], BIG, dist)
        d_cand, cand = top_k_ascending(dist, kq)
        cand = torch.where(d_cand < BIG, cand, -1)
        sel, sel_d = _select_sorted_impl(cand, d_cand, sub_lp, sub_sq,
                                         cap=cap, metric=metric,
                                         precision=precision)
        # padding query rows must not emit edges
        live = (selfi < n)[:, None]
        fwd_t.append(torch.where(live, sel, -1))
        fwd_dt.append(torch.where(live, sel_d, BIG))
    fwd = torch.cat(fwd_t, dim=0)
    fwd_d = torch.cat(fwd_dt, dim=0)
    rev, rev_d = _reverse_device(fwd, fwd_d, rev_cap=cap)

    big_id = 1 << 30
    out = []
    for ti in range(num_tiles):
        # symmetrize: [fwd ++ rev] with carried distances -> id-sort dedupe
        # -> distance sort -> heuristic re-prune
        start = ti * tile
        cand = torch.cat([fwd[start:start + tile], rev[start:start + tile]],
                         dim=1).long()
        cd = torch.cat([fwd_d[start:start + tile], rev_d[start:start + tile]],
                       dim=1)
        selfi = start + torch.arange(tile, device=dev)
        valid = (cand >= 0) & (cand != selfi[:, None])
        key_id = torch.where(valid, cand, big_id)
        si, sd = _sort_with(key_id, cd)
        dup = torch.cat([torch.zeros((tile, 1), dtype=torch.bool, device=dev),
                         si[:, 1:] == si[:, :-1]], dim=1)
        sd = torch.where(dup | (si >= big_id), BIG, sd)
        sd2, si2 = _sort_with(sd, si)
        cand2 = torch.where(sd2 < BIG, si2, -1)
        sel, _ = _select_sorted_impl(cand2, sd2, sub_lp, sub_sq, cap=cap,
                                     metric=metric, precision=precision)
        out.append(sel)
    return torch.cat(out, dim=0)


def build_layer_dispatch(vectors, member_rows: np.ndarray, *, cap: int,
                         k_cand: int, metric: Metric, tile: int = BUILD_TILE,
                         precision: str = "highest"):
    """Device layer build over member_rows: returns (LOCAL-id adjacency
    [ns_pad, cap] on the device, member_rows). Member counts are padded to
    a power of two, as in the reference, so tiles divide evenly."""
    ns = len(member_rows)
    member_rows = np.asarray(member_rows, np.int32)
    ns_pad = _pow2_at_least(ns, 2 * HOST_LAYER_MAX)
    rows_padded = np.zeros(ns_pad, np.int64)
    rows_padded[:ns] = member_rows
    sub = vectors[torch.from_numpy(rows_padded).to(vectors.device)]
    mask = (torch.arange(ns_pad, device=vectors.device) < ns)[:, None]
    sub = torch.where(mask, sub, 0.0)
    kq = min(k_cand + 1, ns)  # +1: self will be dropped
    dev = _layer_fused(sub, ns, cap=cap, kq=kq, metric=metric,
                       tile=min(tile, ns_pad), precision=precision)
    return dev, member_rows


def finish_layer(dev, member_rows: np.ndarray) -> np.ndarray:
    """Fetch a build_layer_dispatch result and map LOCAL ids to GLOBAL."""
    ns = len(member_rows)
    out_local = dev.cpu().numpy().astype(np.int32)[:ns]
    return np.where(out_local >= 0,
                    member_rows[np.maximum(out_local, 0)],
                    NONE).astype(np.int32)


def build_layers_stacked(vectors, members: list, *, cap: int, k_cand: int,
                         metric: Metric, precision: str = "highest") -> list:
    """Build one graph layer for MANY disjoint member sets (IVF-HNSW's
    per-cluster graphs, one level of every partition of partitioned HNSW).
    Returns a list of [len(members[i]), cap] adjacencies in GLOBAL ids (-1
    pad). When every set has at most HOST_LAYER_MAX rows, the sets build on
    the host; else each set is one build_layer_dispatch (the reference vmaps
    them at the largest set's padding; the sets are independent, so each
    pads only to its own power of two), all dispatched before any is
    fetched."""
    metric = Metric.coerce(metric)
    sizes = [len(m) for m in members]
    mx = max(sizes, default=0)
    if mx <= 1:
        return [np.full((s, cap), NONE, np.int32) for s in sizes]

    if mx <= HOST_LAYER_MAX:
        out = []
        for mem in members:
            mem = np.asarray(mem, np.int32)
            if len(mem) <= 1:
                out.append(np.full((len(mem), cap), NONE, np.int32))
                continue
            x = vectors[torch.from_numpy(mem.astype(np.int64))
                        .to(vectors.device)].cpu().numpy()
            loc = _build_layer_host(x, cap=cap,
                                    k_cand=min(k_cand, len(mem) - 1),
                                    metric=metric)
            out.append(np.where(loc >= 0, mem[np.maximum(loc, 0)],
                                NONE).astype(np.int32))
        return out

    pending = [build_layer_dispatch(vectors, mem, cap=cap, k_cand=k_cand,
                                    metric=metric, precision=precision)
               if len(mem) > 1 else None for mem in members]
    return [finish_layer(*job) if job is not None
            else np.full((s, cap), NONE, np.int32)
            for job, s in zip(pending, sizes)]


# ---------------------------------------------------------------------------
# full build
# ---------------------------------------------------------------------------

def build_graph(
    corpus: Corpus,
    *,
    m: int = 16,
    m0: Optional[int] = None,
    ef_construction: int = 200,
    ml: Optional[float] = None,
    seed: int = 42,
    k_cand: Optional[int] = None,
    metric: Optional[Metric] = None,
    progress=None,          # callable(stage: str, fraction: float)
    should_continue=None,   # callable() -> bool; False aborts (BuildInterrupted)
    build_precision: str = "auto",  # "auto" | "highest" | "bf16"
    hierarchy: bool = True,  # False: single-layer graph (levels all 0)
) -> HNSWGraph:
    """Build the full hierarchy on the corpus's device. k_cand is the
    exact-kNN candidate pool fed to the heuristic."""

    def _tick(stage, frac):
        if should_continue is not None and not should_continue():
            raise BuildInterrupted(f"build interrupted at {stage}")
        if progress is not None:
            progress(stage, frac)
    n = corpus.n
    if n > LARGE_N:
        raise NotImplementedError(
            f"n={n} > LARGE_N={LARGE_N} takes the bucketed large-N builder "
            "(build_large.py), which a later slice of the port brings")
    n_pad = corpus.n_pad
    dev = corpus.device
    m0 = m0 or 2 * m
    ml = ml if ml is not None else 1.0 / math.log(2.0)
    metric = metric or corpus.metric
    k_cand = k_cand or min(max(2 * m0, 48), 192)
    if build_precision == "auto":
        # bf16 products for cosine at every size; euclidean's norm formula
        # cancels at bf16, so it keeps f32 until the N^2 cost forces the
        # trade above ~50k rows
        if metric == Metric.COSINE or n > 50000:
            build_precision = "bf16"
        else:
            build_precision = "highest"

    levels_np = assign_levels(n, ml, seed,
                              max_cap=max(int(math.log2(max(n, 2))), 1))
    if not hierarchy:
        levels_np = np.zeros_like(levels_np)
    max_level = int(levels_np.max()) if n else 0

    levels = np.full((n_pad,), NONE, np.int32)
    levels[:n] = levels_np

    adj0 = np.full((n_pad, m0), NONE, np.int32)
    adj_upper = np.full((max_level, n_pad, m), NONE, np.int32)

    pending = []     # (level, device adjacency, member_rows)
    _tick("layer0", 0.0)
    if n > 1:
        pending.append((0, *build_layer_dispatch(
            corpus.vectors, np.arange(n, dtype=np.int32), cap=m0,
            k_cand=k_cand, metric=metric, precision=build_precision)))
    _tick("layer0", 1.0)

    host_layers = []
    for l in range(1, max_level + 1):
        _tick(f"layer{l}", l / max(max_level, 1))
        members = np.nonzero(levels_np >= l)[0].astype(np.int32)
        if len(members) <= 1:
            continue
        if len(members) > HOST_LAYER_MAX:
            pending.append((l, *build_layer_dispatch(
                corpus.vectors, members, cap=m,
                k_cand=min(k_cand, 4 * m), metric=metric,
                precision=build_precision)))
        else:
            host_layers.append((l, members))

    host_x = None
    host_pos = None
    for l, members in host_layers:
        if host_x is None:
            host_x = corpus.vectors[torch.from_numpy(
                members.astype(np.int64)).to(dev)].cpu().numpy()
            host_pos = {int(r): i for i, r in enumerate(members)}
            x = host_x
        else:
            x = host_x[[host_pos[int(r)] for r in members]]
        out_local = _build_layer_host(x, cap=m, k_cand=min(k_cand, 4 * m),
                                      metric=metric)
        adj_upper[l - 1, members] = np.where(
            out_local >= 0, members[np.maximum(out_local, 0)],
            NONE).astype(np.int32)

    _tick("fetch", 0.0)
    for l, dev_adj, rows in pending:
        out = finish_layer(dev_adj, rows)
        if l == 0:
            adj0[:n] = out
        else:
            adj_upper[l - 1, rows] = out
    _tick("fetch", 1.0)

    entry = int(np.nonzero(levels_np == max_level)[0][0]) if n else NONE

    # connectivity repair: exact-kNN construction leaves clustered corpora
    # as one graph per cluster with no inter-cluster edges (see repair.py)
    n_bridges = 0
    if n > 1:
        _tick("repair", 0.0)
        from hnsw_tpu_torch.models.hnsw.repair import bridge_components
        adj0[:n], nb = bridge_components(
            corpus.vectors, corpus.sq_norms, adj0[:n],
            np.arange(n, dtype=np.int32), metric=metric, seed=seed)
        n_bridges += nb
        for l in range(1, max_level + 1):
            members = np.nonzero(levels_np >= l)[0].astype(np.int32)
            if len(members) <= 1:
                continue
            adj_upper[l - 1, members], nb = bridge_components(
                corpus.vectors, corpus.sq_norms, adj_upper[l - 1, members],
                members, metric=metric, seed=seed)
            n_bridges += nb
        _tick("repair", 1.0)

    return HNSWGraph(
        levels=torch.from_numpy(levels).to(dev),
        adj0=torch.from_numpy(adj0).to(dev),
        adj_upper=torch.from_numpy(adj_upper).to(dev),
        entry=entry,
        max_level=max_level,
        m=m, m0=m0,
        ef_construction=ef_construction,
        n=n,
        n_bridges=n_bridges,
    )


# ---------------------------------------------------------------------------
# incremental wave insert
# ---------------------------------------------------------------------------

def _rows(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(dev)


def insert_wave(graph: HNSWGraph, corpus: Corpus, new_rows: np.ndarray,
                new_levels: np.ndarray) -> HNSWGraph:
    """Connect a wave of already-packed new rows into an existing graph.

    Per level l, top-down: batch-search the current graph for
    ef_construction candidates (the layer-l adjacency as layer 0, the
    layers above it as the hierarchy), add intra-wave candidates (an exact
    wave x wave scan, so nodes of one wave see each other), select with the
    heuristic, write forward edges, then re-prune every node that gained
    the new node as a reverse candidate (at most 8 new ones per node).
    Adjacency is edited on the host in numpy, as in the reference."""
    from hnsw_tpu_torch.models.flat import exact_topk
    from hnsw_tpu_torch.models.hnsw.search import hnsw_search_batch

    w = len(new_rows)
    if w == 0:
        return graph
    n_pad = corpus.n_pad
    vectors, v_sq = corpus.vectors, corpus.sq_norms
    metric = corpus.metric
    dev = corpus.device

    levels = graph.levels.cpu().numpy().astype(np.int32)
    if levels.shape[0] != n_pad:
        grown = np.full((n_pad,), NONE, np.int32)
        grown[: levels.shape[0]] = levels
        levels = grown
    levels[new_rows] = new_levels
    new_max = int(max(graph.max_level, new_levels.max()))

    adj0 = graph.adj0.cpu().numpy().astype(np.int32)
    adj_upper = graph.adj_upper.cpu().numpy().astype(np.int32)
    if adj0.shape[0] != n_pad or adj_upper.shape[0] < new_max:
        a0 = np.full((n_pad, graph.m0), NONE, np.int32)
        a0[: adj0.shape[0]] = adj0
        adj0 = a0
        au = np.full((new_max, n_pad, graph.m), NONE, np.int32)
        if adj_upper.size:
            au[: adj_upper.shape[0], : adj_upper.shape[1]] = adj_upper
        adj_upper = au

    # pad the wave to a power-of-two bucket (pad rows carry id -1 / level
    # -1 and are excluded from every write by the at_level mask)
    wp = _pow2_at_least(max(w, 1), 8)
    rows_pad = np.full(wp, NONE, np.int32)
    rows_pad[:w] = new_rows
    levels_pad = np.full(wp, NONE, np.int32)
    levels_pad[:w] = new_levels

    q = vectors[_rows(np.maximum(rows_pad, 0), dev)]
    ef_c = graph.ef_construction

    for l in range(new_max, -1, -1):
        at_level = levels_pad >= l
        if not at_level.any():
            continue
        cap = graph.m0 if l == 0 else graph.m
        cands = []
        if graph.n > 0 and graph.entry >= 0:
            adj_l = torch.tensor(adj0 if l == 0 else adj_upper[l - 1],
                                 device=dev)
            upper = torch.tensor(adj_upper[l:], device=dev) if l < new_max \
                else torch.zeros((0, n_pad, graph.m), dtype=torch.int32,
                                 device=dev)
            # euclidean's norm formula cancels at bf16-class precision: the
            # same auto policy as HNSWIndex.search_batch
            prec = "default" if metric == Metric.COSINE else "highest"
            _, i_c = hnsw_search_batch(
                vectors, v_sq, adj_l, upper,
                torch.full((wp,), graph.entry, dtype=torch.int32, device=dev),
                q, k=ef_c, ef=ef_c, metric=metric, precision=prec)
            cands.append(i_c.cpu().numpy())
        # intra-wave candidates at this level
        wave_members = np.nonzero(at_level)[0]
        if len(wave_members) > 1:
            wrows = rows_pad[wave_members]
            wq = _pow2_at_least(len(wrows), 8)
            wrows_pad = np.zeros(wq, np.int32)
            wrows_pad[: len(wrows)] = wrows
            sub = vectors[_rows(wrows_pad, dev)]
            mask = (torch.arange(wq, device=dev) < len(wrows))[:, None]
            sub = torch.where(mask, sub, 0.0)
            sub_sq = torch.sum(sub * sub, dim=-1)
            kq = min(cap + 1, wq)
            _, loc = exact_topk(sub, sub_sq, q, k=kq, n=len(wrows),
                                metric=metric)
            loc = loc.cpu().numpy()
            cands.append(np.where(loc >= 0, wrows_pad[np.maximum(loc, 0)],
                                  NONE))
        if not cands:
            continue
        cand = np.concatenate(cands, axis=1).astype(np.int32)
        sel = select_from_candidates(
            q, torch.tensor(cand, device=dev), vectors, v_sq,
            torch.tensor(rows_pad, device=dev), cap=cap,
            metric=metric).cpu().numpy()
        target = adj0 if l == 0 else adj_upper[l - 1]
        target[rows_pad[at_level]] = sel[at_level]

        # reverse repair: every selected neighbour gains the new node as a
        # candidate; re-prune the affected nodes at cap
        pairs_dst = sel[at_level].reshape(-1)
        pairs_src = np.repeat(rows_pad[at_level], cap)
        keep = pairs_dst >= 0
        pairs_dst, pairs_src = pairs_dst[keep], pairs_src[keep]
        if len(pairs_dst):
            extra_cap = 8
            order = np.lexsort((np.arange(len(pairs_dst)), pairs_dst))
            ds, ss = pairs_dst[order], pairs_src[order]
            first = np.searchsorted(ds, ds, side="left")
            pos = np.arange(len(ds)) - first
            keep2 = pos < extra_cap
            affected = np.unique(ds)
            na = len(affected)
            ap = _pow2_at_least(na, 8)
            aff_pad = np.full(ap, NONE, np.int32)
            aff_pad[:na] = affected
            extra = np.full((ap, extra_cap), NONE, np.int32)
            rowi = np.searchsorted(affected, ds[keep2])
            extra[rowi, pos[keep2]] = ss[keep2]
            cur = np.full((ap, cap), NONE, np.int32)
            cur[:na] = target[affected]
            cand2 = np.concatenate([cur, extra], axis=1)
            node_vecs = vectors[_rows(np.maximum(aff_pad, 0), dev)]
            sel2 = select_from_candidates(
                node_vecs, torch.tensor(cand2, device=dev), vectors, v_sq,
                torch.tensor(aff_pad, device=dev), cap=cap, metric=metric)
            target[affected] = sel2.cpu().numpy()[:na]

    # entry point: the highest-level node, as the reference's insert keeps
    entry = graph.entry
    if new_max > graph.max_level or entry < 0:
        entry = int(new_rows[new_levels.argmax()])

    return HNSWGraph(
        levels=torch.from_numpy(levels).to(dev),
        adj0=torch.from_numpy(adj0).to(dev),
        adj_upper=torch.from_numpy(adj_upper).to(dev),
        entry=int(entry),
        max_level=new_max,
        m=graph.m, m0=graph.m0,
        ef_construction=graph.ef_construction,
        n=int(graph.n + w),
        n_bridges=graph.n_bridges,
    )

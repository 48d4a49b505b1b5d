"""Clustered HNSW construction for large corpora. Counterpart of
``hnsw_tpu/models/hnsw/build_large.py``.

The exact all-pairs builder (build.py) stops being cheap past ``LARGE_N``
rows. This builder bounds candidate generation to O(N * pool * D): k-means
buckets the layer into ~``cluster_size``-row cells, and each node's exact-kNN
candidate pool is its own cell plus the ``n_probe_clusters`` nearest cells.
With ``spill`` (what ``build_graph`` asks for) a cell's pool is instead every
row that has the cell among its ``n_probe_clusters + 1`` nearest centroids:
a small cluster that k-means gives no centroid of its own is split among
foreign cells whose centroids lie about equally far from all its rows, and
the cell-to-cell probes need not join those pieces, which the search then
cannot cross (recall 0.92 at 290,000 x 256, 64 topics; the exact builder
0.999), while every piece's rows share centroids among their nearest.
Candidates then flow through the same neighbour-selection heuristic and
reverse-edge symmetrization as the exact builder; only candidate generation
is approximate. ``refine_rounds`` of NN-descent (each node re-selects from
its 2-hop ball in the current graph) recover the neighbours that cell
boundaries hid.

The layer stays on the device: the reference's per-cell dispatches and its
``lax.scan`` passes over node tiles become Python loops over cells and node
tiles, and the adjacency crosses to the host once, at ``large_fetch``. Each
node's output row depends only on that node, so how the loops cut the rows
does not change the answer. Two working sets are cut by byte budgets where
the reference uses fixed shapes:
- a cell's members are scored against its pool in row chunks under
  ``CELL_BUDGET_BYTES`` (the reference pads every cell to the largest and
  scores one [mt, pool_pad] block; k-means cells are skewed, and that block
  reaches gigabytes at 4 probes);
- the refinement's [T, cap + cap^2, D] candidate gather runs in row chunks
  under ``REFINE_BUDGET_BYTES`` (the reference's fixed 512-row tile ran out
  of memory at M=24 on the TPU).

"bf16" scoring is f32 products of bf16-rounded operands (the reference's
``preferred_element_type=f32``); "highest" is f32 (TF32 is off).
``_symmetrize_fused`` calls the port's ``_reverse_device``, which keeps every
reverse-edge group start where the reference's can drop some (ROADMAP §C).
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from hnsw_tpu_torch.models.hnsw.build import (
    NONE, _heuristic_impl, _pairwise_among_impl, _pow2_at_least,
    _reverse_device, _select_sorted_impl, _sort_with,
)
from hnsw_tpu_torch.ops.distance import BIG, _dist_bc, as_bf16_f32
from hnsw_tpu_torch.ops.kmeans import train_kmeans
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric
from hnsw_tpu_torch.utils import tracing

# threshold at which build_graph delegates here
LARGE_N = 150_000
# rows of a k-means cell
CLUSTER_SIZE = 4096
# working-set budgets of the cell pass and of the refinement's gather
CELL_BUDGET_BYTES = 1 << 30
REFINE_BUDGET_BYTES = 1 << 30

_BIG_ID = 1 << 30

log = logging.getLogger(__name__)


def _wait(dev) -> None:
    """Wait for the work queued on a CUDA device (on the CPU it is done)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _stage(name: str, dev, **attrs):
    """The span `name` around one stage of the layer, closed after the
    device's work queued inside it, so that it times that work."""
    with tracing.span(name, **attrs):
        yield
        _wait(dev)


def _rows_by_cell(near: np.ndarray, kk: int) -> list:
    """[rows, ascending, whose row of near [ns, p] holds cell c, for c in
    range(kk)], from one stable sort."""
    flat = near.reshape(-1)
    order = np.argsort(flat, kind="stable")
    bounds = np.searchsorted(flat[order], np.arange(kk + 1))
    rows = order // near.shape[1]
    return [rows[bounds[c]:bounds[c + 1]] for c in range(kk)]


def cell_count(ns: int, cluster_size: int = CLUSTER_SIZE) -> int:
    """The k-means cells of a layer of ns rows."""
    return max(2, ns // cluster_size)


def _rows_within(budget: int, per_row: int) -> int:
    return max(1, int(budget) // max(int(per_row), 1))


def _cell_rows(pool: int, kq: int, d: int) -> int:
    """Member rows a cell chunk scores at once under CELL_BUDGET_BYTES: the
    [r, pool] distances with their sort (about 24 bytes an entry) and the
    heuristic's [r, kq, D] gather and [r, kq, kq] pairs."""
    return _rows_within(CELL_BUDGET_BYTES,
                        24 * pool + 8 * kq * d + 12 * kq * kq)


def _refine_rows(c: int, d: int) -> int:
    """Rows of the refinement's [r, c, D] gather under REFINE_BUDGET_BYTES
    (the bf16 rows and their f32 widening)."""
    return _rows_within(REFINE_BUDGET_BYTES, 6 * c * d)


def _gather_dots(q, rows, table, chunk: int):
    """dots[t, c] = q[t] . table[rows[t, c]] in f32, gathered `chunk` rows
    of q at a time. q [T, D] f32, rows [T, C] (>= 0)."""
    out = []
    for s in range(0, q.shape[0], chunk):
        cv = table[rows[s:s + chunk]].float()                  # [r, C, D]
        out.append(torch.einsum("td,tcd->tc", q[s:s + chunk], cv))
    return torch.cat(out, dim=0)


def _dedupe_sorted(cand, d, valid):
    """Id-sort, BIG-out adjacent repeats, distance sort (the reference's two
    variadic sorts). Returns (ids [T, C] ascending by distance, -1 where
    dropped; distances)."""
    key_id = torch.where(valid, cand, _BIG_ID)
    si, sd = _sort_with(key_id, d)
    dup = torch.cat([torch.zeros((si.shape[0], 1), dtype=torch.bool,
                                 device=si.device),
                     si[:, 1:] == si[:, :-1]], dim=1)
    sd = torch.where(dup | (si >= _BIG_ID), BIG, sd)
    sd2, si2 = _sort_with(sd, si)
    return torch.where(sd2 < BIG, si2, -1), sd2


def _cell_build(src, src_sq, pool_rows, mc_rows, n_pool, *, cap: int,
                kq: int, metric: Metric, precision: str, chunk: int):
    """Forward adjacency for one cell: score its members against the probe
    pool (cell + neighbour cells), take the top-kq exact candidates, run the
    construction heuristic; `chunk` member rows at a time. src is the padded
    layer array (bf16 for "bf16", f32 for "highest"); pool_rows [P] and
    mc_rows [MT] are LOCAL layer ids, -1 padded. Returns sel [MT, cap]."""
    dev = src.device
    pool_rows = pool_rows.long()
    mc_rows = mc_rows.long()
    live_pool = (torch.arange(pool_rows.shape[0], device=dev) < n_pool) \
        & (pool_rows >= 0)
    prow = torch.clamp(pool_rows, min=0)
    pv = src[prow].float()                                      # [P, D]
    pv_sq = src_sq[prow]
    # the reference pads every pool past kq: a shorter pool's missing
    # candidates are (BIG, -1), as padding entries would be
    short = max(kq - pool_rows.shape[0], 0)
    out = []
    for s in range(0, mc_rows.shape[0], chunk):
        mc = mc_rows[s:s + chunk]
        mrow = torch.clamp(mc, min=0)
        q = src[mrow].float()
        dots = torch.matmul(q, pv.T)
        dist = _dist_bc(dots, src_sq[mrow][:, None], pv_sq[None, :], metric)
        dist = torch.where(live_pool[None, :], dist, BIG)
        dist = torch.where(pool_rows[None, :] == mc[:, None], BIG, dist)
        d_cand, idx = top_k_ascending(dist, kq)
        cand = torch.where(d_cand < BIG, pool_rows[idx], -1)
        if short:
            d_cand = torch.nn.functional.pad(d_cand, (0, short), value=BIG)
            cand = torch.nn.functional.pad(cand, (0, short), value=-1)
        sel, _ = _select_sorted_impl(cand, d_cand, src, src_sq, cap=cap,
                                     metric=metric, precision=precision)
        out.append(torch.where((mc >= 0)[:, None], sel, -1))
    return torch.cat(out, dim=0)


def _scatter_rows(fwd, idx, vals):
    """fwd[idx] = vals with -1 / out-of-range indices dropped (not clipped:
    a clipped pad index would overwrite the last row)."""
    keep = (idx >= 0) & (idx < fwd.shape[0])
    fwd[idx[keep].long()] = vals[keep].to(fwd.dtype)
    return fwd


def _symmetrize_fused(src, src_sq, fwd, n, *, cap: int, metric: Metric,
                      tile: int, precision: str):
    """Reverse-edge collection + heuristic re-prune at cap: device reverse
    edges, then a pass over node tiles scoring [fwd ++ rev] against each
    node, id-sort dedupe, distance sort, heuristic."""
    ns_pad = fwd.shape[0]
    dev = fwd.device
    n = int(n)
    rev, _ = _reverse_device(fwd, torch.zeros(fwd.shape, dtype=torch.float32,
                                              device=dev), rev_cap=cap)
    out = torch.empty((ns_pad, cap), dtype=torch.int32, device=dev)
    for start in range(0, ns_pad, tile):
        cand = torch.cat([fwd[start:start + tile], rev[start:start + tile]],
                         dim=1).long()                          # [T, 2cap]
        t = cand.shape[0]
        selfi = start + torch.arange(t, device=dev)
        live = (selfi < n)[:, None]
        valid = (cand >= 0) & (cand != selfi[:, None]) & live
        rows = torch.clamp(cand, min=0)
        dots = _gather_dots(src[start:start + t].float(), rows, src, t)
        d = torch.where(valid, _dist_bc(dots, src_sq[start:start + t, None],
                                        src_sq[rows], metric), BIG)
        cand2, sd2 = _dedupe_sorted(cand, d, valid)
        sel, _ = _select_sorted_impl(cand2, sd2, src, src_sq, cap=cap,
                                     metric=metric, precision=precision)
        out[start:start + t] = torch.where(live, sel, -1)
    return out


def _refine_fused(src, src_sq, adj, n, *, cap: int, kq: int, metric: Metric,
                  tile: int, chunk: int):
    """One NN-descent round over a built layer: each node's candidate pool
    is its neighbours + neighbours-of-neighbours (the 2-hop ball of the
    current graph), scored in bf16 (`chunk` rows of the [T, cap + cap^2, D]
    gather at a time), deduped via an id-sort, trimmed to kq, and
    re-selected with the construction heuristic. Returns a refined FORWARD
    adjacency [ns_pad, cap] in local ids (-1 padded); the caller
    re-symmetrizes."""
    ns_pad = src.shape[0]
    dev = src.device
    n = int(n)
    sub_lp = src if src.dtype == torch.bfloat16 else src.to(torch.bfloat16)
    out = torch.empty((ns_pad, cap), dtype=torch.int32, device=dev)
    for start in range(0, ns_pad, tile):
        nb = adj[start:start + tile].long()                     # [T, cap]
        t = nb.shape[0]
        nb2 = adj[torch.clamp(nb, min=0)].long()                # [T, cap, cap]
        nb2 = torch.where((nb >= 0)[:, :, None], nb2, -1)
        cand = torch.cat([nb, nb2.reshape(t, cap * cap)], dim=1)
        selfi = start + torch.arange(t, device=dev)
        valid = (cand >= 0) & (cand != selfi[:, None])
        rows = torch.clamp(cand, min=0)
        q = as_bf16_f32(src[start:start + t].float())
        dots = _gather_dots(q, rows, sub_lp, chunk)
        d = torch.where(valid, _dist_bc(dots, src_sq[start:start + t, None],
                                        src_sq[rows], metric), BIG)
        si2, sd2 = _dedupe_sorted(cand, d, valid)
        d_k = sd2[:, :kq]
        cand_k = si2[:, :kq]
        krows = torch.clamp(cand_k, min=0)
        pair_d = _pairwise_among_impl(sub_lp[krows], src_sq[krows], metric,
                                      "bf16")
        sel = _heuristic_impl(cand_k, d_k, pair_d, cap=cap)
        out[start:start + t] = torch.where((selfi < n)[:, None], sel, -1)
    return out


def build_layer_clustered(
    vectors,                  # [N_pad, D] global corpus tensor
    v_sq,
    member_rows: np.ndarray,  # [ns] global rows in this layer
    *,
    cap: int,
    k_cand: int,
    metric: Metric,
    cluster_size: int = 4096,  # CLUSTER_SIZE, written as the reference's
    n_probe_clusters: int = 2,
    refine_rounds: int = 1,
    seed: int = 42,
    tile: int = 1024,
    precision: str = "bf16",
    spill: bool = False,
    progress=None,            # callable(stage, frac): "large_kmeans",
                              # "large_cells", "large_sym{i}",
                              # "large_refine{i}", "large_fetch"
) -> np.ndarray:
    """One-layer adjacency via bucketed candidate generation, polished by
    refine_rounds of NN-descent (_refine_fused). Returns [ns, cap] of
    GLOBAL row ids (-1 padded). Logs the plan it chose (cell count, largest
    cell, pads, chunk rows) at INFO on this module's logger. A cell's pool
    is its members and those of the n_probe_clusters cells whose centroids
    are nearest its own (the reference's); with spill, every row that has
    the cell among its n_probe_clusters + 1 nearest centroids, and a row's
    cell is its nearest centroid's.

    Records the span hnsw.build.large (attributes: rows, cells, metric,
    precision and the plan's largest_pool, pool_pad, cell_chunk_rows,
    refine_chunk_rows, tile) and inside it four consecutive stages, each
    closed after a wait for its device work: .kmeans (train_kmeans and the
    cells' members and pools), .cells (the padded score arrays and the
    per-cell candidate pass), .symmetrize (the first _symmetrize_fused) and
    .refine (every NN-descent round with its re-symmetrize; attribute
    rounds, 0 where the layer is one cell's size or less). The adjacency's
    fetch ends the outer span."""
    def _tick(stage, frac=0.0):
        if progress is not None:
            progress(stage, frac)

    metric = Metric.coerce(metric)
    dev = vectors.device
    ns = len(member_rows)
    member_rows = np.asarray(member_rows, np.int32)
    kk = cell_count(ns, cluster_size)

    with tracing.span("hnsw.build.large", rows=ns, cells=kk,
                      metric=metric.value, precision=precision) as large:
        with _stage("hnsw.build.large.kmeans", dev):
            # layer 0's member set is the identity (callers pass sorted
            # unique rows, so first == 0 and last == ns - 1 imply arange):
            # use the corpus arrays
            if member_rows[0] == 0 and member_rows[-1] == ns - 1:
                sub, sub_sq = vectors, v_sq
            else:
                gather = torch.from_numpy(member_rows.astype(np.int64)).to(dev)
                sub, sub_sq = vectors[gather], v_sq[gather]
            _tick("large_kmeans")
            cents, assign_t = train_kmeans(sub, sub_sq, ns, k=kk, seed=seed,
                                           iters=3, metric=metric)
            if spill:
                # each row joins the pools of its n_probe_clusters + 1
                # nearest centroids; its cell is the nearest
                c_sq = torch.sum(cents * cents, dim=-1)
                near_d = _dist_bc(torch.matmul(sub[:ns].float(), cents.T),
                                  sub_sq[:ns, None], c_sq[None, :], metric)
                near = top_k_ascending(
                    near_d, min(n_probe_clusters + 1, kk))[1].cpu().numpy()
                del near_d
                members = _rows_by_cell(near[:, :1], kk)
                pool_of = _rows_by_cell(near, kk)
            else:
                assign = assign_t.cpu().numpy()[:ns]
                cents_np = cents.cpu().numpy()

                # neighbour cells by centroid distance (self first)
                cd = cents_np @ cents_np.T
                csq = (cents_np * cents_np).sum(1)
                if metric == Metric.EUCLIDEAN:
                    cdist = csq[:, None] + csq[None, :] - 2 * cd
                else:
                    cdist = -cd / np.maximum(
                        np.sqrt(csq[:, None] * csq[None, :]), 1e-12)
                np.fill_diagonal(cdist, -np.inf)      # self always first
                order = np.argsort(cdist, axis=1)
                probe = order[:, : n_probe_clusters + 1]
                probe[:, 0] = np.arange(kk)

                members = [np.nonzero(assign == c)[0] for c in range(kk)]
                pool_of = [np.concatenate([members[p] for p in probe[c]])
                           for c in range(kk)]
            cmax = max((len(m) for m in members), default=1)
            pool_pad = _pow2_at_least(max(max(len(p) for p in pool_of), 2),
                                      1024)

        # --- per-cell candidate pass: each cell's live members against its
        # live pool, in budgeted row chunks
        with _stage("hnsw.build.large.cells", dev):
            # one padded score array serves every pass: bf16 for "bf16", f32
            # for "highest"
            ns_pad = ((ns + tile - 1) // tile) * tile
            dt = torch.bfloat16 if precision == "bf16" else torch.float32
            src = torch.zeros((ns_pad, sub.shape[1]), dtype=dt, device=dev)
            src[:ns] = sub[:ns].to(dt)
            src_sq = torch.zeros((ns_pad,), dtype=torch.float32, device=dev)
            src_sq[:ns] = sub_sq[:ns]
            del sub, sub_sq

            _tick("large_cells")
            fwd = torch.full((ns_pad, cap), NONE, dtype=torch.int32,
                             device=dev)
            kq = min(k_cand + 1, pool_pad)
            live_cells = [c for c in range(kk) if len(members[c])]
            mt = _pow2_at_least(max((len(members[c]) for c in live_cells),
                                    default=1), min(tile, pool_pad))
            pools = [pool_of[c] for c in live_cells]
            d = src.shape[1]
            largest = max(len(p) for p in pools)
            plan = dict(largest_pool=largest, pool_pad=pool_pad,
                        cell_chunk_rows=_cell_rows(largest, kq, d),
                        refine_chunk_rows=_refine_rows(cap + cap * cap, d),
                        tile=tile)
            large.attrs.update(plan)
            log.info("plan ns=%d kk=%d cmax=%d mt=%d pool_pad=%d "
                     "largest_pool=%d cell_chunk_rows=%d refine_chunk_rows=%d "
                     "tile=%d", ns, kk, cmax, mt, pool_pad, largest,
                     plan["cell_chunk_rows"], plan["refine_chunk_rows"], tile)
            for c, pool in zip(live_cells, pools):
                mc = torch.from_numpy(members[c].astype(np.int64)).to(dev)
                pt = torch.from_numpy(pool.astype(np.int64)).to(dev)
                sel = _cell_build(src, src_sq, pt, mc, len(pool), cap=cap,
                                  kq=kq, metric=metric, precision=precision,
                                  chunk=_cell_rows(len(pool), kq, d))
                fwd = _scatter_rows(fwd, mc, sel)

        # --- symmetrize + NN-descent polish, all on the device
        with _stage("hnsw.build.large.symmetrize", dev):
            _tick("large_sym0")
            out = _symmetrize_fused(src, src_sq, fwd, ns, cap=cap,
                                    metric=metric, tile=tile,
                                    precision=precision)
        rounds = max(refine_rounds, 0) if ns > cluster_size else 0
        with _stage("hnsw.build.large.refine", dev, rounds=rounds):
            for i in range(rounds):
                _tick(f"large_refine{i + 1}")
                fwd2 = _refine_fused(src, src_sq, out, ns, cap=cap,
                                     kq=max(64, 2 * cap),
                                     metric=metric, tile=tile,
                                     chunk=_refine_rows(cap + cap * cap, d))
                _tick(f"large_sym{i + 1}")
                out = _symmetrize_fused(src, src_sq, fwd2, ns, cap=cap,
                                        metric=metric, tile=tile,
                                        precision=precision)

        # the one device -> host adjacency crossing of the layer
        _tick("large_fetch")
        out_local = out.cpu().numpy()[:ns]
        _tick("large_fetch", 1.0)
    return np.where(out_local >= 0,
                    member_rows[np.maximum(out_local, 0)],
                    NONE).astype(np.int32)

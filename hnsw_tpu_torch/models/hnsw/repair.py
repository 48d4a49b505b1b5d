"""Layer-0 connectivity repair for batch-built HNSW graphs.

Copy of ``hnsw_tpu/models/hnsw/repair.py`` (numpy/scipy), with the one
representative-vector gather done in torch.

The exact-kNN batch builder (build.py) gives every node its true nearest
neighbors — which, on clustered corpora, all live in the same cluster. The
result is a high-quality graph per cluster and no edges between clusters, so
a batch builder must repair connectivity explicitly.

Recipe — all host work except one small rep-vector gather:
1. `connected_labels`: scipy connected-components over the undirected
   closure of the adjacency (already host numpy at this point in the build).
2. `bridge_components`: sample <= reps_per_comp representatives per initial
   component (merging only unions rep sets, so initial reps stay valid for
   every later round), gather their vectors in one device op, compute one
   [R, R] rep-pairwise distance matrix, then run all Boruvka rounds as pure
   numpy masking/argmin over that cached matrix. Components at least halve
   per round, so <= log2(#components) rounds.

Bridges go into a free adjacency slot when one exists, else replace the last
(worst, since slots are ascending by distance) slot.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from hnsw_tpu_torch.types import Metric

# cap on representative rows scored per Boruvka round: bounds the [R, R]
# pairwise matrix; components beyond it wait for a later round
MAX_REPS = 4096
_EPS = 1e-12


def connected_labels(adj) -> np.ndarray:
    """Connected-component labels over the UNDIRECTED closure of adj
    [N, M] (-1 padded). Returns int32 [N] where every node carries its
    component's smallest row id; rows without edges keep their own index."""
    adj = np.asarray(adj)
    n, m = adj.shape
    if n == 0:
        return np.zeros((0,), np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), m)
    cols = adj.reshape(-1)
    keep = cols >= 0
    g = csr_matrix(
        (np.ones(int(keep.sum()), np.int8), (rows[keep], cols[keep])),
        shape=(n, n))
    ncomp, comp = connected_components(g, directed=True, connection="weak")
    first = np.full(ncomp, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    return first[comp].astype(np.int32)


def _host_pairwise(x: np.ndarray, metric) -> np.ndarray:
    """All-pairs distances among rep vectors, numpy (same formulas as
    ops/distance.distances_from_dots)."""
    m = Metric(metric)
    x = np.asarray(x, np.float32)
    dots = x @ x.T
    sq = np.einsum("ij,ij->i", x, x)
    if m == Metric.COSINE:
        denom = np.sqrt(np.maximum(sq[:, None] * sq[None, :], _EPS))
        return 1.0 - dots / denom
    if m == Metric.EUCLIDEAN:
        return np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * dots,
                                  0.0))
    if m == Metric.DOT:
        return -dots
    raise ValueError(f"unknown metric {metric}")


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a):
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def bridge_components(
    vectors: torch.Tensor,     # [N_pad, D] device corpus
    v_sq: torch.Tensor,        # [N_pad] (unused; kept for call symmetry)
    adj: np.ndarray,           # [ns, cap] GLOBAL row ids, -1 padded (copy returned)
    member_rows: np.ndarray,   # [ns] global row ids the adjacency indexes
    *,
    metric: Metric,
    seed: int = 42,
    reps_per_comp: int = 8,
) -> tuple[np.ndarray, int]:
    """Boruvka-bridge adj until one connected component remains.

    adj holds global row ids; connectivity is computed over the local
    (member) index space. Returns (new adj, number of bridge edges added).
    """
    del v_sq
    ns, cap = adj.shape
    if ns <= 1:
        return adj, 0
    member_rows = np.asarray(member_rows, np.int32)
    # global row id -> local position (members are unique), vectorized
    inv_map = np.full(int(member_rows.max()) + 1, -1, np.int32)
    inv_map[member_rows] = np.arange(ns, dtype=np.int32)
    local = np.where(adj >= 0, inv_map[np.maximum(adj, 0)], -1).astype(np.int32)

    labels = connected_labels(local)
    uniq_labels = np.unique(labels)
    ncomp = len(uniq_labels)
    if ncomp <= 1:
        return adj, 0                      # already connected: zero device work
    adj = adj.copy()

    # sample reps per INITIAL component (merges only union rep sets)
    rng = np.random.default_rng(seed)
    rpc = max(1, min(reps_per_comp, MAX_REPS // ncomp))
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], uniq_labels)
    rep_locals, rep_comp = [], []
    for ci in range(ncomp):
        lo = bounds[ci]
        hi = bounds[ci + 1] if ci + 1 < ncomp else ns
        members = order[lo:hi]
        take = members if len(members) <= rpc else \
            rng.choice(members, rpc, replace=False)
        rep_locals.extend(int(x) for x in take)
        rep_comp.extend([ci] * len(take))
    rep_locals = np.asarray(rep_locals, np.int32)
    rep_comp = np.asarray(rep_comp, np.int32)
    r = len(rep_locals)

    # ONE device gather + transfer; ONE host pairwise matrix for all rounds.
    rows = torch.from_numpy(member_rows[rep_locals].astype(np.int64))
    rv = vectors[rows.to(vectors.device)].float().cpu().numpy()
    dmat = _host_pairwise(rv, metric)

    uf = _UnionFind(ncomp)
    n_bridges = 0
    # bridge slots are load-bearing: a later bridge overwriting an earlier
    # one silently un-merges components the union-find believes are joined.
    # Track how many tail slots each row has devoted to bridges so every
    # new bridge takes the next-worst slot instead.
    bridge_slots = np.zeros(ns, np.int32)
    ridx = np.arange(r)

    for _ in range(64):  # components at least halve per round
        comp_root = np.array([uf.find(ci) for ci in range(ncomp)], np.int32)
        rep_roots = comp_root[rep_comp]
        uniq_roots = np.unique(comp_root)
        if len(uniq_roots) <= 1:
            break
        # bound host work per round: only reps of the first MAX_REPS roots
        # originate bridges this round (targets stay unrestricted); the
        # waiting roots merge in later rounds
        if len(uniq_roots) > MAX_REPS:
            live = np.isin(rep_roots, uniq_roots[:MAX_REPS])
        else:
            live = np.ones(r, bool)
        d = np.where(rep_roots[:, None] == rep_roots[None, :], np.inf, dmat)
        j = np.argmin(d, axis=1)
        dv = d[ridx, j]

        # per live root: its best (rep, foreign rep) pair
        best: dict[int, tuple[float, int, int]] = {}
        for i in np.nonzero(live & np.isfinite(dv))[0]:
            c = int(rep_roots[i])
            if c not in best or dv[i] < best[c][0]:
                best[c] = (float(dv[i]), int(rep_locals[i]),
                           int(rep_locals[j[i]]))
        if not best:
            break
        for c, (_, a, b) in best.items():
            ra = uf.find(int(rep_comp[rep_locals == a][0]))
            rb = uf.find(int(rep_comp[rep_locals == b][0]))
            if ra == rb:
                continue
            _add_edge(adj, local, bridge_slots, a, b, member_rows)
            _add_edge(adj, local, bridge_slots, b, a, member_rows)
            uf.union(ra, rb)
            n_bridges += 1
    return adj, n_bridges


def _add_edge(adj: np.ndarray, local: np.ndarray, bridge_slots: np.ndarray,
              a: int, b: int, member_rows: np.ndarray) -> None:
    """Append local edge a->b (global id member_rows[b]); free slot if any,
    else evict the worst non-bridge slot (slots are ascending by distance;
    earlier bridges at the tail are never overwritten)."""
    if (local[a] == b).any():
        return
    cap = adj.shape[1]
    free = np.nonzero(adj[a] < 0)[0]
    if len(free):
        slot = int(free[0])
        # a bridge landing in a tail slot must be protected from later
        # evictions too
        bridge_slots[a] = max(int(bridge_slots[a]), cap - slot) \
            if slot >= cap - 1 - int(bridge_slots[a]) else bridge_slots[a]
    else:
        slot = cap - 1 - int(bridge_slots[a])
        if slot < 0:       # row is all bridges already (cap tiny): reuse last
            slot = cap - 1
        else:
            bridge_slots[a] += 1
    adj[a, slot] = member_rows[b]
    local[a, slot] = b

"""Sharded index construction over the device mesh. Counterpart of
``hnsw_tpu/parallel/build.py``.

The P partition graphs are the same program over stacked arrays. Each layer
of every partition is one ``_layer_fused`` build (exact-kNN candidates ->
selection heuristic -> reverse edges -> re-prune) on the device that owns
the partition; the reference runs them as one ``shard_map`` of a ``vmap``
per layer. Upper layers of at most ``HOST_LAYER_MAX`` nodes build in numpy,
as there. The shuffle, the split and the level draws are the reference's
seeded numpy draws, so both packages build the same members per layer.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import DEFAULTS
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.hnsw.build import (BUILD_TILE, HOST_LAYER_MAX,
                                              _build_layer_host, _layer_fused,
                                              _pow2_at_least)
from hnsw_tpu_torch.models.hnsw.graph import NONE, assign_levels
from hnsw_tpu_torch.models.partitioned import PartitionedHNSWIndex
from hnsw_tpu_torch.parallel.mesh import Mesh, make_mesh
from hnsw_tpu_torch.parallel.sharded import stacked_vectors


def _partition_layer(vecs, mem, nn: int, *, cap: int, kq: int, tile: int,
                     metric, precision: str):
    """One layer of one partition on its device. vecs: [S_pad, D] the
    partition's rows; mem: [SL_pad] partition-local member ids (-1 pad);
    nn members. Returns [SL_pad, cap] partition-local ids (-1 pad)."""
    sub = vecs[mem.clamp(min=0).long()]
    live = (torch.arange(sub.shape[0], device=sub.device) < nn)[:, None]
    out = _layer_fused(torch.where(live, sub, 0.0), nn, cap=cap, kq=kq,
                       metric=metric, tile=tile, precision=precision)
    return torch.where(out >= 0, mem[out.clamp(min=0)], NONE)


def build_partitioned_hnsw_sharded(
    data,
    *,
    num_partitions: Optional[int] = None,   # default: mesh size
    mesh: Optional[Mesh] = None,
    M: int = DEFAULTS["M"],
    max_M0: Optional[int] = None,
    ef_construction: int = 50,   # reference value (partitioned_hnsw.clj:109)
    metric="cosine",
    ids=None,
    seed: int = DEFAULTS["seed"],
    shuffle: bool = True,
    k_cand: Optional[int] = None,
    build_precision: str = "auto",
    device=None,
    **_ignored,
) -> PartitionedHNSWIndex:
    """Build a PartitionedHNSWIndex with its partitions laid over the mesh
    (default: make_mesh(device=device)); partition i is built on entry
    i // (P / mesh size). num_partitions must divide over the mesh
    (ValueError). The returned index holds vectors_p / v_sq_p, and all its
    stacked arrays lie on the mesh's first device, the corpus's, where the
    single-device search reads them; ShardedPartitionedHNSW splits them over
    the mesh (views where a piece's device is the first)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    corpus = as_corpus(data, metric=metric, ids=ids, device=mesh.first)
    dcount = mesh.size
    n = corpus.n
    p = num_partitions or dcount
    if p % dcount:
        raise ValueError(f"num_partitions {p} not divisible by mesh size "
                         f"{dcount}")
    m0 = max_M0 or 2 * M
    ml = 1.0 / math.log(2.0)
    k_cand = k_cand or min(max(2 * m0, 48), 192)
    chunk = max((n + p - 1) // p, 1)
    if build_precision == "auto":
        build_precision = "highest" if chunk <= 50000 else "bf16"

    rng = np.random.default_rng(seed)
    order = (rng.permutation(n) if shuffle else
             np.arange(n)).astype(np.int32)
    s_pad = _pow2_at_least(chunk, 8)

    rows_p = np.full((p, s_pad), NONE, np.int32)
    counts = np.zeros(p, np.int32)
    levels_p = np.full((p, s_pad), NONE, np.int32)
    for i in range(p):
        rows = order[i * chunk:(i + 1) * chunk]
        rows_p[i, : len(rows)] = rows
        counts[i] = len(rows)
        if len(rows):
            cap_l = max(int(math.log2(max(len(rows), 2))), 1)
            levels_p[i, : len(rows)] = assign_levels(
                len(rows), ml, seed + i, max_cap=cap_l)
    max_level = int(levels_p.max()) if n else 0

    first = mesh.first
    rows_t = torch.from_numpy(rows_p).to(first)
    vecs, v_sq = stacked_vectors(corpus, rows_t)          # [P, S, D], [P, S]
    # partition i's rows on the device that owns it
    per = p // dcount
    owner = [mesh.device_list[i // per] for i in range(p)]
    vecs_dev = [vecs[i].to(owner[i]) for i in range(p)]
    tile = min(BUILD_TILE, s_pad)

    def stacked_layer(mem_idx, mem_counts, *, cap, kq, tile):
        """Every partition's layer, each dispatched on its device before
        any is fetched; returns [P, SL_pad, cap] on the first device."""
        outs = [_partition_layer(
            vecs_dev[i], torch.from_numpy(mem_idx[i]).to(owner[i]),
            int(mem_counts[i]), cap=cap, kq=kq, tile=tile,
            metric=corpus.metric, precision=build_precision)
            for i in range(p)]
        return torch.stack([o.to(first) for o in outs])

    # ---- layer 0: members = every local row -----------------------------
    ident = np.tile(np.arange(s_pad, dtype=np.int32), (p, 1))
    adj0 = stacked_layer(ident, counts, cap=m0,
                         kq=min(k_cand + 1, s_pad), tile=tile)

    # ---- upper layers ----------------------------------------------------
    adj_upper = np.full((p, max(max_level, 0), s_pad, M), NONE, np.int32)
    for l in range(1, max_level + 1):
        at = levels_p >= l
        mem_counts = at.sum(axis=1).astype(np.int32)
        mx = int(mem_counts.max()) if p else 0
        if mx <= 1:
            continue
        if mx <= HOST_LAYER_MAX:
            # tiny routing layers: numpy per partition
            for i in range(p):
                mem = np.nonzero(at[i])[0].astype(np.int32)
                if len(mem) <= 1:
                    continue
                x = vecs[i, torch.from_numpy(mem).long().to(first)] \
                    .cpu().numpy()[:, : corpus.dim]
                outl = _build_layer_host(x, cap=M,
                                         k_cand=min(k_cand, 4 * M),
                                         metric=corpus.metric)
                adj_upper[i, l - 1, mem] = np.where(
                    outl >= 0, mem[np.maximum(outl, 0)], NONE)
            continue
        sl_pad = _pow2_at_least(mx, 8)
        mem_idx = np.full((p, sl_pad), NONE, np.int32)
        for i in range(p):
            mem = np.nonzero(at[i])[0].astype(np.int32)
            mem_idx[i, : len(mem)] = mem
        out = stacked_layer(mem_idx, mem_counts, cap=M,
                            kq=min(min(k_cand, 4 * M) + 1, sl_pad),
                            tile=min(tile, sl_pad)).cpu().numpy()
        for i in range(p):
            mem = mem_idx[i, : mem_counts[i]]
            adj_upper[i, l - 1, mem] = out[i, : mem_counts[i]]

    # entry per partition: the first node at the partition's own top level
    entries = np.full(p, NONE, np.int32)
    for i in range(p):
        if counts[i]:
            entries[i] = int(np.argmax(levels_p[i, : counts[i]]))

    return PartitionedHNSWIndex(
        corpus, num_partitions=p, vectors_p=vecs, v_sq_p=v_sq,
        rows_p=rows_t, adj0_p=adj0.to(torch.int32),
        adj_upper_p=torch.from_numpy(adj_upper).to(first),
        entries_p=torch.from_numpy(entries).to(first),
        m=M, m0=m0, ef_construction=ef_construction, seed=seed)

"""Partitioned HNSW: N disjoint sub-graphs searched as one. Counterpart of
``hnsw_tpu/models/partitioned.py``.

The reference shuffles the data (critical for ordered corpora), splits it
into N=8 equal chunks, builds one HNSW per partition, fans the query out to
every partition with an adaptive per-partition k and merges the union.

Here the P sub-graphs build level by level as stacked builds
(``build_layers_stacked``), and search runs ONE shared beam per query over
the globalized adjacency (edges never cross partitions), seeded with the
best sampled rows of every partition (``sample_entries_grouped``). The hop
loop is HNSW's, with its packed-neighbourhood bf16 path
(``prepare_hop_fast_path``): on the card each hop is scored by the
``hop_score`` kernel at width c = expand * M0 = 256.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import DEFAULTS, Mode, ef_for
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.hnsw.search import (hnsw_search_batch,
                                               prepare_hop_fast_path,
                                               sample_entries_grouped)
from hnsw_tpu_torch.models.hnsw.shadow import PACK_BYTES_CAP, HopShadow
from hnsw_tpu_torch.types import Corpus, Metric, round_up


class PartitionedHNSWIndex(ANNIndex):
    family = "partitioned_hnsw"

    ENTRY_SAMPLE_PER_PARTITION = 256
    SEEDS_PER_PARTITION = 4

    def __init__(self, corpus: Corpus, *, num_partitions: int,
                 rows_p, adj0_p, adj_upper_p, entries_p,
                 m: int, m0: int, ef_construction: int, seed: int = 42,
                 vectors_p=None, v_sq_p=None):
        """vectors_p / v_sq_p, the partition-stacked vectors and norms, are
        stored as given (None when absent): only the sharded search reads
        them (parallel/sharded.py), which forms them from the corpus when
        they are None. This search runs on the globalized adjacency."""
        super().__init__(corpus)
        self.num_partitions = num_partitions
        self.vectors_p = vectors_p       # [P, S, D] or None
        self.v_sq_p = v_sq_p             # [P, S] or None
        self.rows_p = rows_p             # [P, S] global rows (-1 pad)
        self.adj0_p = adj0_p             # [P, S, M0] local ids
        self.adj_upper_p = adj_upper_p   # [P, L, S, M]
        self.entries_p = entries_p       # [P] local entry (-1: empty)
        self.m, self.m0 = m, m0
        self.ef_construction = ef_construction
        self.seed = seed
        # the shared beam carries P interleaved partition frontiers; e=8
        # halves the hop count at the same candidate work (c = 8 * M0)
        self.expand = 8
        self._adj_g = None
        self._entry_samples = None
        self._shadow = HopShadow()

    def _globalized(self):
        """The P disjoint sub-graphs merged into ONE corpus-indexed
        adjacency (edges never cross partitions)."""
        if self._adj_g is None:
            rows = self.rows_p.cpu().numpy()             # [P, S] global rows
            adj0 = self.adj0_p.cpu().numpy()             # [P, S, M0] local ids
            g = np.full((self.corpus.n_pad, adj0.shape[-1]), -1, np.int32)
            for p in range(rows.shape[0]):
                ok = rows[p] >= 0
                loc = adj0[p][ok]
                g[rows[p][ok]] = np.where(
                    loc >= 0, rows[p][np.maximum(loc, 0)], -1)
            self._adj_g = torch.from_numpy(g).to(self.corpus.device)
        return self._adj_g

    def _partition_seed_rows(self):
        """[P, S] evenly spaced global row sample per partition (-1 pad) for
        sample_entries_grouped."""
        if self._entry_samples is None:
            rows = self.rows_p.cpu().numpy()
            s = self.ENTRY_SAMPLE_PER_PARTITION
            samp = np.full((rows.shape[0], s), -1, np.int32)
            for p in range(rows.shape[0]):
                ok = rows[p][rows[p] >= 0]
                if len(ok):
                    sel = np.unique(np.linspace(0, len(ok) - 1,
                                                min(s, len(ok))).astype(int))
                    samp[p, : len(sel)] = ok[sel]
            self._entry_samples = torch.from_numpy(samp).to(
                self.corpus.device)
        return self._entry_samples

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     ef: Optional[int] = None,
                     k_per_partition: Optional[int] = None):
        """One shared beam per query seeded in every partition. ef=420 is
        the family's accurate point; k_per_partition (the reference's knob,
        full k in precise mode) widens ef to at least P * kpp."""
        q = self.corpus.pad_queries(queries)
        mode = Mode.coerce(mode)
        if k_per_partition is None and mode == Mode.PRECISE:
            k_per_partition = k
        if ef is None:
            ef = 420 if mode == Mode.ACCURATE else ef_for(mode, k)
        if k_per_partition is not None:
            ef = max(ef, self.num_partitions * k_per_partition)

        adj_g = self._globalized()
        entries = sample_entries_grouped(
            self.corpus.vectors, self.corpus.sq_norms,
            self._partition_seed_rows(), q, metric=self.corpus.metric,
            r=self.SEEDS_PER_PARTITION)
        kw = prepare_hop_fast_path(self._shadow, self.corpus, adj_g,
                                   expand=self.expand,
                                   pack_bytes_cap=PACK_BYTES_CAP)
        no_upper = torch.zeros((0, adj_g.shape[0], self.m), dtype=torch.int32,
                               device=adj_g.device)
        return hnsw_search_batch(
            self.corpus.vectors, self.corpus.sq_norms,
            adj_g, no_upper, entries, q,
            k=k, ef=ef, metric=self.corpus.metric, rerank=4 * k, **kw)

    def index_info(self) -> Dict[str, Any]:
        sizes = (self.rows_p >= 0).sum(dim=1).cpu().numpy()
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "num_partitions": self.num_partitions,
            "partition_sizes": sizes.tolist(),
            "M": self.m, "M0": self.m0,
            "ef_construction": self.ef_construction,
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "params": {
                "num_partitions": self.num_partitions, "M": self.m,
                "M0": self.m0, "ef_construction": self.ef_construction,
                "seed": self.seed,
            },
            "arrays": {
                "rows_p": self.rows_p.cpu().numpy(),
                "adj0_p": self.adj0_p.cpu().numpy(),
                "adj_upper_p": self.adj_upper_p.cpu().numpy(),
                "entries_p": self.entries_p.cpu().numpy(),
            },
        }

    @classmethod
    def from_state(cls, corpus: Corpus,
                   state: Dict[str, Any]) -> "PartitionedHNSWIndex":
        """vectors_p / v_sq_p are carried when the arrays hold them."""
        p, a = state["params"], state["arrays"]
        dev = corpus.device

        def arr(name, dtype=np.int32):
            if name not in a:
                return None
            return torch.from_numpy(np.array(a[name], dtype=dtype)).to(dev)

        return cls(
            corpus, num_partitions=int(p["num_partitions"]),
            rows_p=arr("rows_p"),
            adj0_p=arr("adj0_p"), adj_upper_p=arr("adj_upper_p"),
            entries_p=arr("entries_p"),
            m=int(p["M"]), m0=int(p["M0"]),
            ef_construction=int(p["ef_construction"]),
            seed=int(p.get("seed", 42)),
            vectors_p=arr("vectors_p", np.float32),
            v_sq_p=arr("v_sq_p", np.float32))


def build_partitioned_hnsw(
    data,
    *,
    num_partitions: int = 8,   # reference default (partitioned_hnsw.clj)
    M: int = DEFAULTS["M"],
    max_M0: Optional[int] = None,
    ef_construction: int = 50,  # reference passes 50 (partitioned_hnsw.clj:109)
    metric="cosine",
    ids=None,
    seed: int = DEFAULTS["seed"],
    shuffle: bool = True,
    progress=None,             # callable(stage: str, fraction: float);
                               # stages "stack_l{l}", "bridge_l{l}"
    device=None,
    **_ignored,
) -> PartitionedHNSWIndex:
    """Shuffle, split into P equal partitions, and build every partition's
    graph level by level (one stacked build per level, then connectivity
    repair per partition-layer), on the CUDA card unless device says
    otherwise."""
    from hnsw_tpu_torch.models.hnsw.build import build_layers_stacked
    from hnsw_tpu_torch.models.hnsw.graph import assign_levels
    from hnsw_tpu_torch.models.hnsw.repair import bridge_components

    def _tick(stage, frac):
        if progress is not None:
            progress(stage, frac)
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    n = corpus.n
    p = max(1, min(num_partitions, max(n, 1)))
    m0 = max_M0 or 2 * M

    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    shard_size = round_up(max((n + p - 1) // p, 1), 8)

    rows_p = np.full((p, shard_size), -1, np.int32)
    counts = []
    for i in range(p):
        rows = order[i * ((n + p - 1) // p):(i + 1) * ((n + p - 1) // p)]
        rows_p[i, : len(rows)] = rows
        counts.append(len(rows))
    ml = 1.0 / math.log(2.0)
    levels = [assign_levels(c, ml, seed + i,
                            max_cap=max(int(math.log2(max(c, 2))), 1))
              for i, c in enumerate(counts)]
    max_l = max((int(lv.max()) for lv in levels if len(lv)), default=0)
    k_cand = min(max(2 * m0, 48), 192)
    precision = "bf16" if corpus.metric == Metric.COSINE else "highest"

    glob2loc = np.full(corpus.n_pad, -1, np.int32)
    for i in range(p):
        glob2loc[rows_p[i, : counts[i]]] = np.arange(counts[i],
                                                     dtype=np.int32)

    adj0 = np.full((p, shard_size, m0), -1, np.int32)
    adju = np.full((p, max_l, shard_size, M), -1, np.int32)
    for l in range(0, max_l + 1):
        cap = m0 if l == 0 else M
        kc = k_cand if l == 0 else min(k_cand, 4 * M)
        parts = []
        members = []
        for i in range(p):
            mem = rows_p[i, : counts[i]][levels[i] >= l] if l else \
                rows_p[i, : counts[i]]
            if len(mem) >= 2:
                parts.append(i)
                members.append(mem.astype(np.int32))
        if not parts:
            continue
        _tick(f"stack_l{l}", 0.0)
        adjs = build_layers_stacked(corpus.vectors, members, cap=cap,
                                    k_cand=kc, metric=corpus.metric,
                                    precision=precision)
        _tick(f"bridge_l{l}", 0.0)
        for i, mem, adj in zip(parts, members, adjs):
            # connectivity repair per partition-layer (host Boruvka
            # bridging, as build_graph does per layer)
            adj, _ = bridge_components(corpus.vectors, corpus.sq_norms,
                                       adj, mem, metric=corpus.metric,
                                       seed=seed + i)
            loc = np.where(adj >= 0, glob2loc[np.maximum(adj, 0)], -1)
            if l == 0:
                adj0[i, : len(mem)] = loc
            else:
                adju[i, l - 1, glob2loc[mem]] = loc
        _tick(f"bridge_l{l}", 1.0)

    # entry = a top-level node per partition; -1 for an empty partition, so
    # the beam never seeds on a padding row
    entries = np.full(p, -1, np.int32)
    for i in range(p):
        if counts[i]:
            top = int(levels[i].max())
            entries[i] = int(np.nonzero(levels[i] >= top)[0][0])

    dev = corpus.device
    return PartitionedHNSWIndex(
        corpus, num_partitions=p, rows_p=torch.from_numpy(rows_p).to(dev),
        adj0_p=torch.from_numpy(adj0).to(dev),
        adj_upper_p=torch.from_numpy(adju).to(dev),
        entries_p=torch.from_numpy(entries).to(dev),
        m=M, m0=m0, ef_construction=ef_construction, seed=seed)

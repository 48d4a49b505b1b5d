"""Lightning: instant-build partition scan. Counterpart of
``hnsw_tpu/models/lightning.py``.

A random equal split (default) or a 3-iteration k-means ("smart"), one
centroid per partition; search picks a percent of the partitions by
centroid distance (or at random when ``use_centroids`` is false) and scans
them with the masked slab scan it shares with IVF-FLAT. The percent comes
from the partition-count-adaptive table of ``config.lightning_percent``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import Mode, lightning_percent
from hnsw_tpu_torch.models._partition_scan import (PartitionTable,
                                                   probe_mask_from_centroids,
                                                   scan_search)
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.ivf_flat import IVFFlatIndex
from hnsw_tpu_torch.ops.kmeans import random_partition, train_kmeans
from hnsw_tpu_torch.types import Corpus


class LightningIndex(IVFFlatIndex):
    """The slab scan of IVF-FLAT with a near-free build and its own probe
    choice (percent schedule, or random)."""

    family = "lightning"

    def __init__(self, corpus: Corpus, table: PartitionTable, *,
                 partitioning: str = "random", use_centroids: bool = True,
                 seed: int = 42):
        super().__init__(corpus, table, partitioning=partitioning, seed=seed)
        self.use_centroids = use_centroids
        # the reference's seeded numpy draw: the same seed and call order
        # give the same random probes in both packages
        self._rng = np.random.default_rng(seed)

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     percent: Optional[float] = None):
        q = self.corpus.pad_queries(queries)
        kp = self.table.k_parts
        if percent is None:
            percent = lightning_percent(mode, kp)
        probes = max(1, min(kp, math.ceil(percent * kp)))
        if self.use_centroids:
            mask, _ = probe_mask_from_centroids(
                q, self.table.centroids, num_probes=probes,
                metric=self.corpus.metric)
        else:
            # random partitions per query: a batched Gumbel top-k, uniform
            # sampling without replacement for the whole batch
            b = q.shape[0]
            g = self._rng.gumbel(size=(b, kp))
            sel = np.argpartition(-g, probes - 1, axis=1)[:, :probes]
            mask_np = np.zeros((b, kp), bool)
            np.put_along_axis(mask_np, sel, True, axis=1)
            mask = torch.from_numpy(mask_np).to(q.device)
        t = self.table
        return scan_search(t.vectors, t.v_sq, t.perm, t.starts, t.lens, mask,
                           q, k=k, cmax=t.cmax, metric=self.corpus.metric)

    def index_info(self) -> Dict[str, Any]:
        info = super().index_info()
        info["type"] = self.family
        info["use_centroids"] = self.use_centroids
        return info

    def to_state(self) -> Dict[str, Any]:
        s = super().to_state()
        s["params"]["use_centroids"] = self.use_centroids
        return s

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "LightningIndex":
        base = IVFFlatIndex.from_state(corpus, state)
        p = state["params"]
        return cls(corpus, base.table, partitioning=base.partitioning,
                   use_centroids=bool(p.get("use_centroids", True)),
                   seed=base.seed)


def build_lightning_index(
    data,
    *,
    num_partitions: int = 32,       # reference build default
    partitioning: str = "random",   # "random" | "smart" / "kmeans"
    use_centroids: bool = True,
    metric="cosine",
    ids=None,
    seed: int = 42,
    device=None,
    **_ignored,
) -> LightningIndex:
    """A random split, or 3 Lloyd iterations for "smart", then the
    cluster-sorted table, on the CUDA card unless device says otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    k = max(1, min(num_partitions, max(corpus.n, 1)))
    cents = None
    if corpus.n == 0:
        assign = np.zeros(0, np.int32)
        cents = np.zeros((k, corpus.dim), np.float32)
    elif partitioning in ("smart", "kmeans"):
        cents_t, assign_t = train_kmeans(
            corpus.vectors, corpus.sq_norms, corpus.n,
            k=k, seed=seed, iters=3, metric=corpus.metric)
        assign = assign_t[: corpus.n].cpu().numpy()
        cents = cents_t.cpu().numpy()
    else:
        assign = random_partition(corpus.n, k, seed)
    table = PartitionTable.build(corpus, assign, centroids=cents)
    return LightningIndex(corpus, table, partitioning=partitioning,
                          use_centroids=use_centroids, seed=seed)

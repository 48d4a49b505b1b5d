"""IVF-FLAT: k-means coarse quantizer + flat cluster scan. Counterpart of
``hnsw_tpu/models/ivf_flat.py``.

Partitions live as contiguous slabs of a cluster-sorted permutation
(``models/_partition_scan.py:PartitionTable``). Two search paths:

- the masked scan (``scan_search``), every slab against every query; best
  when the probes cover a large share of the partitions;
- the grouped probe scan (``grouped_search``), queries grouped per cluster
  so that the work scales with the probed share.

Beyond the reference's clustering: capacity-balanced assignment
(``ops/kmeans.py:balanced_assign``) and optional SOAR-style
multi-assignment (``spill``), with duplicate-aware merges.

Two faults of the reference are not copied (ROADMAP §C): ``from_state``
casts a bf16 table before it gathers the slab rows, and an explicit
``table_dtype="bf16"`` with euclidean raises ``ValueError`` (that metric's
exact scan needs f32 slabs).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import IVF_FLAT_PROBES, Mode
from hnsw_tpu_torch.models._partition_scan import (
    PartitionTable, _permute_slab, default_qcap, grouped_search,
    probe_mask_from_centroids, scan_search)
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.ops.kmeans import (balanced_assign, random_partition,
                                       spill_assign, topc_clusters,
                                       train_kmeans)
from hnsw_tpu_torch.types import Corpus, Metric

TABLE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class IVFFlatIndex(ANNIndex):
    family = "ivf_flat"

    def __init__(self, corpus: Corpus, table: PartitionTable, *,
                 partitioning: str = "kmeans", seed: int = 42,
                 spill: int = 0):
        super().__init__(corpus)
        self.table = table
        self.partitioning = partitioning
        self.seed = seed
        self.spill = spill
        self._last_dropped = 0  # grouped-path qcap drops (see index_info)

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     num_probes: Optional[int] = None, scan: str = "auto"):
        """scan: "auto" | "grouped" | "full". "grouped" skips un-probed
        work (wins when probes/partitions is small); "full" scans every
        slab with a probe mask (wins when probes cover most partitions)."""
        q = self.corpus.pad_queries(queries)
        if num_probes is None:
            num_probes = IVF_FLAT_PROBES[Mode.coerce(mode)]
        t = self.table
        p = min(num_probes, t.k_parts)
        copies = 1 + (1 if self.spill else 0)
        if scan == "auto":
            # grouped work ~ 4*B*P*cmax*D against full B*N_slab*D; with
            # balanced slabs cmax ~ 1.25*copies*N/K, so grouped wins when
            # ~5*c*P < K
            scan = "grouped" if 5 * copies * p <= t.k_parts else "full"
        mask, probe_ids = probe_mask_from_centroids(
            q, t.centroids, num_probes=p, metric=self.corpus.metric)
        if scan == "grouped":
            qcap = default_qcap(q.shape[0], p, t.k_parts)
            precision = ("default" if self.corpus.metric == Metric.COSINE
                         else "highest")
            d, r, dropped = grouped_search(
                t.vectors, t.v_sq, t.perm, t.starts, t.lens, probe_ids, q,
                k=k, cmax=t.cmax, qcap=qcap, metric=self.corpus.metric,
                precision=precision)
            self._last_dropped = dropped  # device scalar; read lazily
            return d, r
        return scan_search(
            t.vectors, t.v_sq, t.perm, t.starts, t.lens, mask, q,
            k=k, cmax=t.cmax, metric=self.corpus.metric,
            dedup=self.spill > 0)

    def index_info(self) -> Dict[str, Any]:
        sizes = self.table.partition_sizes()
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "num_partitions": self.table.k_parts,
            "partitioning": self.partitioning,
            "spill": self.spill,
            "cmax": self.table.cmax,
            "last_grouped_dropped_pairs": int(self._last_dropped),
            "partition_sizes": {"min": int(sizes.min()) if len(sizes) else 0,
                                "max": int(sizes.max()) if len(sizes) else 0,
                                "avg": float(sizes.mean()) if len(sizes) else 0.0},
        }

    def to_state(self) -> Dict[str, Any]:
        t = self.table
        return {
            "params": {"partitioning": self.partitioning, "seed": self.seed,
                       "cmax": t.cmax, "k_parts": t.k_parts,
                       "spill": self.spill,
                       "table_dtype": ("bf16" if t.vectors.dtype ==
                                       torch.bfloat16 else "f32")},
            "arrays": {
                "perm": t.perm.cpu().numpy(),
                "starts": t.starts.cpu().numpy(),
                "lens": t.lens.cpu().numpy(),
                "centroids": t.centroids.cpu().numpy(),
            },
        }

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "IVFFlatIndex":
        p, a = state["params"], state["arrays"]
        dev = corpus.device

        def arr(name, dtype):
            return torch.from_numpy(np.array(a[name], dtype=dtype)).to(dev)

        perm = arr("perm", np.int32)
        cmax = int(p["cmax"])
        # the slab rows, then cmax guard rows; the corpus is cast before
        # the gather, so a bf16 table never passes through an f32 copy
        permuted, v_sq = _permute_slab(
            corpus.vectors, corpus.sq_norms, perm[: len(perm) - cmax].long(),
            dtype=TABLE_DTYPES[p.get("table_dtype", "f32")],
            out_rows=len(perm))
        table = PartitionTable(
            vectors=permuted, v_sq=v_sq, perm=perm,
            starts=arr("starts", np.int32), lens=arr("lens", np.int32),
            centroids=arr("centroids", np.float32),
            cmax=cmax, k_parts=int(p["k_parts"]))
        return cls(corpus, table, partitioning=p.get("partitioning", "kmeans"),
                   seed=int(p.get("seed", 42)), spill=int(p.get("spill", 0)))


def build_ivf_flat_index(
    data,
    *,
    num_partitions: int = 24,      # reference default (ivf_flat.clj)
    partitioning: str = "kmeans",  # "kmeans" | "random"
    max_iterations: int = 10,      # fixed Lloyd iterations
    metric="cosine",
    ids=None,
    seed: int = 42,
    spill: int = 0,                # 1 = SOAR-style secondary assignment
    balance: float = 1.25,         # cluster-size cap factor (0 = unbalanced)
    table_dtype: str = "auto",     # "auto" | "f32" | "bf16" slab storage;
                                   # auto: bf16 above 600k rows for cosine
                                   # and dot, f32 otherwise
    device=None,
    **_ignored,
) -> IVFFlatIndex:
    """k-means (or a random split), balanced assignment and optional spill,
    then the cluster-sorted table, on the CUDA card unless device says
    otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    if table_dtype == "auto":
        table_dtype = "bf16" if (corpus.n > 600_000
                                 and corpus.metric != Metric.EUCLIDEAN) \
            else "f32"
    if table_dtype == "bf16" and corpus.metric == Metric.EUCLIDEAN:
        raise ValueError("table_dtype='bf16' needs cosine or dot: the "
                         "euclidean scan scores f32 slabs")
    tdt = TABLE_DTYPES[table_dtype]
    k = max(1, min(num_partitions, max(corpus.n, 1)))
    secondary = None
    if corpus.n == 0:
        assign = np.zeros(0, np.int32)
        cents = np.zeros((k, corpus.dim), np.float32)
    elif partitioning == "random":
        assign = random_partition(corpus.n, k, seed)
        cents = None
    else:
        cents_t, _ = train_kmeans(
            corpus.vectors, corpus.sq_norms, corpus.n,
            k=k, seed=seed, iters=max_iterations, metric=corpus.metric)
        cents = cents_t.cpu().numpy()
        c_width = min(max(4, 1 + (1 if spill else 0)), k)
        topd, topi = topc_clusters(corpus.vectors, corpus.sq_norms, corpus.n,
                                   cents_t, c=c_width, metric=corpus.metric)
        if balance and k > 1:
            cap = int(math.ceil(balance * corpus.n / k))
            assign = balanced_assign(topd, topi, k, cap)
        else:
            cap = corpus.n
            assign = topi[:, 0].astype(np.int32)
        if spill and k > 1:
            secondary = spill_assign(assign, topd, topi, k, cap)
    table = PartitionTable.build(corpus, assign, centroids=cents,
                                 secondary=secondary, dtype=tdt)
    return IVFFlatIndex(corpus, table, partitioning=partitioning, seed=seed,
                        spill=spill if secondary is not None else 0)

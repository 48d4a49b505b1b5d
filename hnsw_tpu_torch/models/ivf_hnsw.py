"""IVF-HNSW: k-means partitions with a graph per cluster. Counterpart of
``hnsw_tpu/models/ivf_hnsw.py``.

The reference partitions with k-means++ and Lloyd, builds a pure HNSW per
partition, and at search probes the num-probes nearest centroids with a
per-mode ef (``config.IVF_HNSW_MODES``: turbo 1 probe, ef 50 ... precise 5,
ef 300).

Here all per-cluster graphs live in ONE global adjacency whose edges never
cross clusters, each anchored at its medoid. A query probes its nearest
centroids and seeds one shared beam at the probed medoids plus the best of
each probed cluster's sampled rows; the hop loop is HNSW's, with its
packed-neighbourhood bf16 path (on the card the ``hop_score`` kernel at
width c = expand * M0 = 256).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import IVF_HNSW_MODES, Mode
from hnsw_tpu_torch.models._partition_scan import probe_mask_from_centroids
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.hnsw.build import build_layers_stacked
from hnsw_tpu_torch.models.hnsw.search import (hnsw_search_batch,
                                               prepare_hop_fast_path,
                                               sample_entries_grouped)
from hnsw_tpu_torch.ops.kmeans import (balanced_assign, topc_clusters,
                                       train_kmeans)
from hnsw_tpu_torch.types import Corpus


class IVFHNSWIndex(ANNIndex):
    family = "ivf_hnsw"

    # same budget rule as HNSWIndex for the packed-neighbourhood bf16 table
    PACK_BYTES_CAP = 6 << 30

    # sampled member rows per cluster, seeded beside the medoid: a single
    # entry per probe inside a shared beam under-explores a ~1000-row cell
    SAMPLES_PER_CLUSTER = 8
    SEEDS_PER_PROBE = 3     # top sample seeds added per probed cluster

    def __init__(self, corpus: Corpus, *, centroids, medoids, adj0,
                 num_partitions: int, m: int, seed: int = 42,
                 expand: int = 8, samples=None):
        super().__init__(corpus)
        self.centroids = centroids     # [K, D]
        self.medoids = medoids         # int32 [K] entry row per cluster
        self.adj0 = adj0               # [N_pad, M0] cluster-local edges
        self.num_partitions = num_partitions
        self.m = m
        self.seed = seed
        # expand=8: hop width c = 256, half the shared beam's hops
        self.expand = expand
        # [K, SAMPLES_PER_CLUSTER] evenly spaced member rows (-1 pad); None
        # in states saved before samples existed
        self.samples = samples
        self._vec_lp = None
        self._nbr_pack = None
        self._nbr_sq = None

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     num_probes: Optional[int] = None,
                     ef: Optional[int] = None,
                     search_percent: Optional[float] = None):
        q = self.corpus.pad_queries(queries)
        mode = Mode.coerce(mode)
        probes_m, ef_m = IVF_HNSW_MODES[mode]
        if search_percent is not None and num_probes is None:
            # legacy float search-percent -> probe count
            num_probes = max(1, round(search_percent * self.num_partitions))
        p = min(num_probes or probes_m, self.num_partitions)
        ef = max(ef or ef_m, k)

        _, probe_ids = probe_mask_from_centroids(
            q, self.centroids, num_probes=p, metric=self.corpus.metric)
        entries = self.medoids[probe_ids]                   # [B, p]
        if self.samples is not None and self.SEEDS_PER_PROBE > 0:
            # sampled seeds of every cluster in one [B, K*S] product, top-R
            # within each cluster, gathered at the probed cluster ids
            b = q.shape[0]
            tops = sample_entries_grouped(
                self.corpus.vectors, self.corpus.sq_norms, self.samples, q,
                metric=self.corpus.metric,
                r=self.SEEDS_PER_PROBE).reshape(b, self.samples.shape[0], -1)
            probed = torch.gather(
                tops, 1, probe_ids[:, :, None].expand(-1, -1, tops.shape[2]))
            entries = torch.cat([entries, probed.reshape(b, -1)], dim=1)
        no_upper = torch.zeros((0,) + tuple(self.adj0.shape),
                               dtype=torch.int32,
                               device=self.adj0.device)[:, :, : self.m]
        kw = prepare_hop_fast_path(self, self.corpus, self.adj0,
                                   expand=self.expand,
                                   pack_bytes_cap=self.PACK_BYTES_CAP)
        return hnsw_search_batch(
            self.corpus.vectors, self.corpus.sq_norms,
            self.adj0, no_upper, entries, q,
            k=k, ef=ef, metric=self.corpus.metric, rerank=4 * k, **kw)

    def index_info(self) -> Dict[str, Any]:
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "num_partitions": self.num_partitions,
            "M": self.m,
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "params": {"num_partitions": self.num_partitions, "M": self.m,
                       "seed": self.seed, "expand": self.expand},
            "arrays": {"centroids": self.centroids.cpu().numpy(),
                       "medoids": self.medoids.cpu().numpy(),
                       "adj0": self.adj0.cpu().numpy(),
                       **({"samples": self.samples.cpu().numpy()}
                          if self.samples is not None else {})},
        }

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "IVFHNSWIndex":
        """A state without "expand" predates expand=8 and loads with the
        reference's legacy default of 4."""
        p, a = state["params"], state["arrays"]
        dev = corpus.device

        def arr(name, dtype):
            return torch.from_numpy(np.array(a[name], dtype=dtype)).to(dev)

        return cls(corpus, centroids=arr("centroids", np.float32),
                   medoids=arr("medoids", np.int32),
                   adj0=arr("adj0", np.int32),
                   num_partitions=int(p["num_partitions"]), m=int(p["M"]),
                   seed=int(p.get("seed", 42)),
                   expand=int(p.get("expand", 4)),
                   samples=(arr("samples", np.int32)
                            if "samples" in a else None))


def build_ivf_hnsw_index(
    data,
    *,
    num_partitions: int = 16,
    M: int = 16,
    max_iterations: int = 10,
    metric="cosine",
    ids=None,
    seed: int = 42,
    device=None,
    **_ignored,
) -> IVFHNSWIndex:
    """k-means (balanced reassignment above one cluster), a medoid and a
    row sample per cluster, and every cluster's graph in one stacked build,
    on the CUDA card unless device says otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    dev = corpus.device
    n = corpus.n
    kparts = max(1, min(num_partitions, max(n, 1)))
    m0 = 2 * M

    if n == 0:
        return IVFHNSWIndex(
            corpus, centroids=torch.zeros((kparts, corpus.d_pad), device=dev),
            medoids=torch.zeros(kparts, dtype=torch.int32, device=dev),
            adj0=torch.full((corpus.n_pad, m0), -1, dtype=torch.int32,
                            device=dev),
            num_partitions=kparts, m=M, seed=seed)

    cents_t, assign_t = train_kmeans(
        corpus.vectors, corpus.sq_norms, n, k=kparts, seed=seed,
        iters=max_iterations, metric=corpus.metric)
    if kparts > 1:
        # balanced reassignment keeps cluster sizes within ~1.25x of the
        # mean: near-equal probe cost, and the stacked build pads every
        # cluster to the largest one's power of two
        topd, topi = topc_clusters(corpus.vectors, corpus.sq_norms, n,
                                   cents_t, c=min(4, kparts),
                                   metric=corpus.metric)
        cap_sz = int(np.ceil(1.25 * n / kparts))
        assign = balanced_assign(topd, topi, kparts, cap_sz)
    else:
        assign = assign_t[:n].cpu().numpy()

    # medoid per cluster = the member closest to its centroid
    a_dev = torch.from_numpy(assign.astype(np.int64)).to(dev)
    own = cents_t[a_dev]
    d2 = (corpus.sq_norms[:n]
          - 2.0 * torch.sum(corpus.vectors[:n, : cents_t.shape[1]] * own,
                            dim=-1)
          + torch.sum(own * own, dim=-1)).cpu().numpy()
    medoids = np.zeros(kparts, np.int32)
    member_sets = []
    for c in range(kparts):
        members = np.nonzero(assign == c)[0].astype(np.int32)
        member_sets.append(members)
        if len(members):
            medoids[c] = members[int(np.argmin(d2[members]))]

    # evenly spaced member-row sample per cluster: search-time seeds
    s_pc = IVFHNSWIndex.SAMPLES_PER_CLUSTER
    samples = np.full((kparts, s_pc), -1, np.int32)
    for ci, members in enumerate(member_sets):
        if len(members):
            sel = np.unique(np.linspace(0, len(members) - 1,
                                        min(s_pc, len(members))).astype(int))
            samples[ci, : len(sel)] = members[sel]

    adj0 = np.full((corpus.n_pad, m0), -1, np.int32)
    adjs = build_layers_stacked(
        corpus.vectors, member_sets, cap=m0, k_cand=2 * m0,
        metric=corpus.metric,
        precision="highest" if n <= 50000 else "bf16")
    for members, adj in zip(member_sets, adjs):
        if len(members) > 1:
            adj0[members] = adj

    return IVFHNSWIndex(
        corpus, centroids=cents_t,
        medoids=torch.from_numpy(medoids).to(dev),
        adj0=torch.from_numpy(adj0).to(dev),
        num_partitions=kparts, m=M, seed=seed,
        samples=torch.from_numpy(samples).to(dev))

"""Centroid probing. Counterpart of ``probe_mask_from_centroids`` in
``hnsw_tpu/models/_partition_scan.py``; the partition table and the grouped
scans of that module come with the partition-scan families (IVF-FLAT,
Lightning), which are not ported yet."""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.distance import distances_from_dots
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric


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

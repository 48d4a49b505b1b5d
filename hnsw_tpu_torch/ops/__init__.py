"""Compute ops: distance scoring, top-k selection and merge, k-means, the
sort network, and the wrappers of the hand-written CUDA kernels (hop,
expand, merge, gather, descent, scan, probes). Exports what
``hnsw_tpu/ops/__init__.py`` exports."""

from hnsw_tpu_torch.ops.distance import (
    distances_from_dots,
    gather_score,
    pairwise_distances,
    score_block,
)
from hnsw_tpu_torch.ops.topk import mask_invalid, merge_topk, top_k_ascending

__all__ = [
    "score_block",
    "distances_from_dots",
    "gather_score",
    "pairwise_distances",
    "top_k_ascending",
    "merge_topk",
    "mask_invalid",
]

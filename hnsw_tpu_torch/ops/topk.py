"""Top-k selection and merge. PyTorch counterpart of ``hnsw_tpu/ops/topk.py``.

``lax.top_k`` returns ties with the lower index first; ``torch.topk`` does
not promise any tie order, so selection here is a stable ascending sort
followed by a slice.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.distance import BIG


def mask_invalid(dists: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """BIG where not valid."""
    return torch.where(valid, dists, BIG)


def top_k_ascending(dists: torch.Tensor, k: int):
    """Smallest-k along the last axis, ties lower index first.
    Returns (dists [.., k], idx [.., k] int64)."""
    d, idx = torch.sort(dists, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def merge_topk(dists_a, ids_a, dists_b, ids_b, k: int):
    """Merge two ascending top-k candidate sets (concat + reselect)."""
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    dk, sel = top_k_ascending(d, k)
    return dk, torch.gather(i, -1, sel)


def dedupe_ascending(dists, ids, k: int):
    """Drop duplicate ids from an ascending candidate list, keeping the first
    (best) occurrence, then reselect top-k."""
    eq = ids[..., None, :] == ids[..., :, None]            # [..., C, C]
    c = ids.shape[-1]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    dup = torch.any(eq & earlier, dim=-1)
    d = torch.where(dup, BIG, dists)
    dk, sel = top_k_ascending(d, k)
    return dk, torch.gather(ids, -1, sel)

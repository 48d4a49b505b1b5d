"""Unified API: one entry point over the index families. Counterpart of
``hnsw_tpu/api/__init__.py``: the build dispatcher by family name (with the
reference aliases), the auto-sizing helper, search / batch / filtered
search, index info and type, persistence and the capability predicates.
Indexes are built on the CUDA card unless the options say ``device=``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from hnsw_tpu_torch.config import Mode
from hnsw_tpu_torch.io.persist import index_exists, load_index, save_index
from hnsw_tpu_torch.models import FAMILIES
from hnsw_tpu_torch.models.base import ANNIndex


def build_index(data, index_type: str = "hnsw", **opts) -> ANNIndex:
    """Build an index family by name: flat, hnsw, partitioned_hnsw,
    ivf_hnsw, ivf_flat, lightning, hybrid_lsh, pcaf (+ the reference
    aliases brute_force, ultra_fast, pure_hnsw, partitioned, lsh). Common
    opts: metric=, ids=, seed=, device=; the rest go to the family's
    build function."""
    key = str(index_type).lstrip(":").lower().replace("-", "_")
    if key not in FAMILIES:
        raise ValueError(
            f"unknown index type {index_type!r}; one of {sorted(set(FAMILIES))}")
    return FAMILIES[key](data, **opts)


def build_best_for_size(data, policy: str = "tpu", **opts) -> ANNIndex:
    """Auto-select a family by corpus size.

    policy="tpu" (default) is the JAX package's measured policy: the
    coarse-only int8 flat scan up to 2,000,000 rows, then HNSW. No H100
    ranking of the families has been measured for the port yet. A caller's
    opts win over the policy's (precision= included).

    policy="reference" reproduces the reference wrapper's sizing table
    (<1k hnsw, <10k partitioned HNSW, else IVF-FLAT)."""
    n = len(data) if not hasattr(data, "n") else data.n
    if policy == "reference":
        if n < 1000:
            return build_index(data, "hnsw", **opts)
        if n < 10000:
            return build_index(data, "partitioned_hnsw", **opts)
        return build_index(data, "ivf_flat", **opts)
    if n <= 2_000_000:
        return build_index(data, "flat",
                           **{"precision": "int8", "int8_fetch": 0, **opts})
    return build_index(data, "hnsw", **opts)


def search_knn(index: ANNIndex, query, k: int = 10,
               mode: Mode = Mode.BALANCED) -> List[dict]:
    """Single-query search: [{'id', 'distance'}, ...] ascending."""
    return index.search(query, k, mode)


def batch_search_knn(index: ANNIndex, queries, k: int = 10,
                     mode: Mode = Mode.BALANCED) -> List[List[dict]]:
    """Batched search, one result list per query."""
    return index.search_many(queries, k, mode)


def filtered_search_knn(index: ANNIndex, query, k: int,
                        predicate: Callable[[Any], bool],
                        mode: Mode = Mode.BALANCED) -> List[dict]:
    """Search keeping only hits whose external id passes predicate."""
    return index.search_filtered(query, k, predicate, mode)


def index_info(index: ANNIndex) -> Dict[str, Any]:
    return index.index_info()


def index_type(index: ANNIndex) -> str:
    """The family name."""
    return index.index_type


def supports_batch(index: ANNIndex) -> bool:
    return index.supports_batch


def supports_filter(index: ANNIndex) -> bool:
    return index.supports_filter


def supports_persistence(index: ANNIndex) -> bool:
    return index.supports_persistence


__all__ = [
    "build_index", "build_best_for_size",
    "search_knn", "batch_search_knn", "filtered_search_knn",
    "index_info", "index_type",
    "save_index", "load_index", "index_exists",
    "supports_batch", "supports_filter", "supports_persistence",
]

"""The HNSW family: an index from ``build_hnsw_index`` with the
configuration's ``index`` settings, searched with
``HNSWIndex.search_batch`` at its ``k``, ``mode`` and ``ef``."""

from hnsw_tpu_torch.models.hnsw import build_hnsw_index


def build(rows, cfg, device):
    ix = cfg["index"]
    return build_hnsw_index(rows, M=ix["M"], max_M0=ix["max_M0"],
                            ef_construction=ix["ef_construction"],
                            metric=cfg["metric"], device=device)


def search(index, queries, cfg):
    """(distances [B, k], rows [B, k]) as tensors on the index's device."""
    return index.search_batch(queries, cfg["k"], cfg["mode"], ef=cfg["ef"])

"""Index families. The JAX package has eight; flat and HNSW are ported. The
other six keep their names (and the reference aliases) in FAMILIES, and
building or loading one raises NotImplementedError naming the ROADMAP item
that ports it."""

from hnsw_tpu_torch.models.flat import FlatIndex, build_flat_index
from hnsw_tpu_torch.models.hnsw import HNSWIndex, build_hnsw_index

# family (and alias) -> ROADMAP §A item that ports it
UNPORTED = {
    "partitioned": "A9", "partitioned_hnsw": "A9",
    "lightning": "A8", "ivf_flat": "A8",
    "ivf_hnsw": "A9",
    "lsh": "A10", "hybrid_lsh": "A10",
    "pcaf": "A10",
}


def unported(family: str):
    """Raise for a family the port does not have yet."""
    if family in UNPORTED:
        raise NotImplementedError(
            f"index family {family!r} is not ported yet "
            f"(ROADMAP item {UNPORTED[family]})")
    raise ValueError(f"unknown index family {family!r}")


def _later(family: str):
    def build(data, **opts):
        unported(family)
    build.__name__ = f"build_{family}"
    return build


FAMILIES = {
    "flat": build_flat_index,
    "brute_force": build_flat_index,
    "hnsw": build_hnsw_index,
    "ultra_fast": build_hnsw_index,       # reference alias (ultra_fast.clj)
    "pure_hnsw": build_hnsw_index,        # reference alias (pure_hnsw.clj)
    **{name: _later(name) for name in UNPORTED},
}

# family name -> class, for loaders that dispatch on a saved family
INDEX_CLASSES = {"flat": FlatIndex, "hnsw": HNSWIndex}

__all__ = ["FlatIndex", "HNSWIndex", "build_flat_index", "build_hnsw_index",
           "FAMILIES", "INDEX_CLASSES", "UNPORTED", "unported"]

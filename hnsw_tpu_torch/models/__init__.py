"""Index families ported so far: flat and HNSW."""

from hnsw_tpu_torch.models.flat import FlatIndex, build_flat_index
from hnsw_tpu_torch.models.hnsw import HNSWIndex, build_hnsw_index

# family name -> class, for loaders that dispatch on a saved family
INDEX_CLASSES = {"flat": FlatIndex, "hnsw": HNSWIndex}

__all__ = ["FlatIndex", "HNSWIndex", "build_flat_index", "build_hnsw_index",
           "INDEX_CLASSES"]

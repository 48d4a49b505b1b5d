"""Index families: the eight of the JAX package, under its names and the
reference aliases. Flat/exact (the recall ground truth), HNSW, partitioned
HNSW, Lightning, IVF-FLAT, IVF-HNSW, multi-probe LSH and PCAF."""

from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.flat import FlatIndex, build_flat_index
from hnsw_tpu_torch.models.hnsw import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.ivf_flat import IVFFlatIndex, build_ivf_flat_index
from hnsw_tpu_torch.models.ivf_hnsw import IVFHNSWIndex, build_ivf_hnsw_index
from hnsw_tpu_torch.models.lightning import (LightningIndex,
                                             build_lightning_index)
from hnsw_tpu_torch.models.lsh import HybridLSHIndex, build_lsh_index
from hnsw_tpu_torch.models.partitioned import (PartitionedHNSWIndex,
                                               build_partitioned_hnsw)
from hnsw_tpu_torch.models.pcaf import PCAFIndex, build_pcaf_index

FAMILIES = {
    "flat": build_flat_index,
    "brute_force": build_flat_index,
    "hnsw": build_hnsw_index,
    "ultra_fast": build_hnsw_index,       # reference alias (ultra_fast.clj)
    "pure_hnsw": build_hnsw_index,        # reference alias (pure_hnsw.clj)
    "partitioned": build_partitioned_hnsw,
    "partitioned_hnsw": build_partitioned_hnsw,
    "lightning": build_lightning_index,
    "ivf_flat": build_ivf_flat_index,
    "ivf_hnsw": build_ivf_hnsw_index,
    "lsh": build_lsh_index,
    "hybrid_lsh": build_lsh_index,
    "pcaf": build_pcaf_index,
}

# family name -> class, for loaders that dispatch on a saved family
INDEX_CLASSES = {
    cls.family: cls
    for cls in (FlatIndex, HNSWIndex, IVFFlatIndex, LightningIndex,
                PartitionedHNSWIndex, IVFHNSWIndex, HybridLSHIndex, PCAFIndex)
}

__all__ = [
    "ANNIndex",
    "FlatIndex", "build_flat_index",
    "HNSWIndex", "build_hnsw_index",
    "IVFFlatIndex", "build_ivf_flat_index",
    "LightningIndex", "build_lightning_index",
    "PartitionedHNSWIndex", "build_partitioned_hnsw",
    "IVFHNSWIndex", "build_ivf_hnsw_index",
    "HybridLSHIndex", "build_lsh_index",
    "PCAFIndex", "build_pcaf_index",
    "FAMILIES", "INDEX_CLASSES",
]

"""Multi-device runtime. Counterpart of ``hnsw_tpu/parallel/``.

Corpus and partition axes are split over a mesh of devices driven by one
process (``mesh.py``); each device searches or builds its share, and the
top-k merge is an all-gather to the mesh's first device plus a stable
reselect (``sharded.py``, ``build.py``).
"""

from hnsw_tpu_torch.parallel.build import build_partitioned_hnsw_sharded
from hnsw_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh
from hnsw_tpu_torch.parallel.sharded import (
    ShardedFlatIndex,
    ShardedIVFFlat,
    ShardedPartitionedHNSW,
    sharded_exact_topk,
)

__all__ = [
    "make_mesh", "device_count",
    "sharded_exact_topk", "ShardedFlatIndex", "ShardedIVFFlat",
    "ShardedPartitionedHNSW", "build_partitioned_hnsw_sharded",
    "Mesh",
]

"""hnsw_tpu_torch: the PyTorch / CUDA port of ``hnsw_tpu/`` for one NVIDIA H100.

Laid out like ``hnsw_tpu/`` (types, config, ops, models, models/hnsw, io,
api, parallel, bench, apps, utils), so each module's counterpart is found
under the same name. It never imports JAX or the JAX package; the tests
import both and hold the port against it.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
The TPU's Pallas kernels on the main path are hand-written CUDA kernels in
``csrc/``, built with nvcc for sm_90a at first use (``ops/_cuda.py``).

The exact ("highest") paths of the JAX package are true f32, so TF32 is
turned off for matrix products and convolutions here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from hnsw_tpu_torch.config import DEFAULTS, Mode  # noqa: E402
from hnsw_tpu_torch.types import Corpus, Metric, SearchResult  # noqa: E402
from hnsw_tpu_torch.api import (  # noqa: E402
    batch_search_knn,
    build_best_for_size,
    build_index,
    filtered_search_knn,
    index_exists,
    index_info,
    index_type,
    load_index,
    save_index,
    search_knn,
)
from hnsw_tpu_torch.api.simple import Index  # noqa: E402
from hnsw_tpu_torch.models import (  # noqa: E402
    FAMILIES,
    FlatIndex,
    HNSWIndex,
    HybridLSHIndex,
    IVFFlatIndex,
    IVFHNSWIndex,
    LightningIndex,
    PartitionedHNSWIndex,
    PCAFIndex,
    build_ivf_hnsw_index,
    build_partitioned_hnsw,
)
from hnsw_tpu_torch.models.base import ANNIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Corpus", "Metric", "SearchResult", "Mode", "DEFAULTS",
    "build_index", "build_best_for_size",
    "search_knn", "batch_search_knn", "filtered_search_knn",
    "index_info", "index_type",
    "save_index", "load_index", "index_exists",
    "Index",
    "ANNIndex", "FlatIndex", "HNSWIndex", "IVFFlatIndex", "LightningIndex",
    "PartitionedHNSWIndex", "IVFHNSWIndex", "HybridLSHIndex", "PCAFIndex",
    "build_partitioned_hnsw", "build_ivf_hnsw_index",
    "FAMILIES",
    "__version__",
]

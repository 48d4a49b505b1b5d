"""hnsw_tpu_torch: the PyTorch / CUDA port of hnsw_tpu for one NVIDIA H100.

Laid out like ``hnsw_tpu`` (types, config, ops, models, models/hnsw, io), so
each module's counterpart is found under the same name. It never imports JAX
or the JAX package; the tests import both and hold the port against it.

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

__all__ = ["Corpus", "Metric", "SearchResult", "Mode", "DEFAULTS"]

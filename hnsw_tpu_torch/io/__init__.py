"""Persistence and data pipeline: index save/load, corpus loaders, seeded
synthetic data generation. Exports what ``hnsw_tpu/io/__init__.py``
exports."""

from hnsw_tpu_torch.io.datagen import (DIMENSION_PRESETS, SIZE_PRESETS,
                                       generate_vectors)
from hnsw_tpu_torch.io.loader import get_best_available_data, load_json_corpus
from hnsw_tpu_torch.io.persist import index_exists, load_index, save_index

__all__ = [
    "save_index", "load_index", "index_exists",
    "generate_vectors", "DIMENSION_PRESETS", "SIZE_PRESETS",
    "load_json_corpus", "get_best_available_data",
]

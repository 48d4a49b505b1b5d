"""Shared helpers for index builders (copy of ``hnsw_tpu/models/common.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from hnsw_tpu_torch.types import Corpus


def as_corpus(data, *, metric="cosine", ids: Optional[Sequence[Any]] = None,
              pad_rows_to: int = 8, device=None) -> Corpus:
    """Accept a Corpus, a host array [n, dim], or the reference's native data
    shape — a sequence of [id, vector] pairs (ultra_fast.clj:334-344).
    A given Corpus keeps its device; others are packed onto `device` (the
    CUDA card unless the caller passes another)."""
    if isinstance(data, Corpus):
        return data
    if isinstance(data, (list, tuple)) and len(data) and \
            isinstance(data[0], (list, tuple)) and len(data[0]) == 2 and \
            np.ndim(data[0][1]) == 1:
        return Corpus.from_pairs(data, metric=metric, pad_rows_to=pad_rows_to,
                                 device=device)
    return Corpus.from_array(np.asarray(data), metric=metric, ids=ids,
                             pad_rows_to=pad_rows_to, device=device)

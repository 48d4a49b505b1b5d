"""Carry a built index across from the JAX package.

An HNSW graph is this system's counterpart of a model's weights: serving
cannot run without one. ``from_reference`` takes what ``hnsw_tpu``'s
``HNSWIndex.to_state()`` returns (numpy arrays ``levels``, ``adj0``,
``adj_upper`` and the params ``entry``, ``max_level``, ``M``, ``M0``, ...)
together with the vectors the graph was built on, packs the vectors into the
same ``Corpus`` layout, and returns the port's ``HNSWIndex`` over the
identical graph. It reads plain numpy and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.types import Corpus, Metric


def from_reference(vectors: np.ndarray, state: Dict[str, Any], *,
                   metric: "Metric | str", device, **index_kwargs) -> HNSWIndex:
    """The port's HNSWIndex over `vectors` [n, dim] and the graph in
    `state`. index_kwargs (pack_dim, pack_precision, entry_mode, ...) go to
    HNSWIndex."""
    corpus = Corpus.from_array(np.asarray(vectors, np.float32), metric=metric,
                               device=device)
    n_pad = np.asarray(state["arrays"]["adj0"]).shape[0]
    if n_pad != corpus.n_pad or int(state["params"]["n"]) != corpus.n:
        raise ValueError(f"graph of {state['params']['n']} rows "
                         f"({n_pad} padded) does not fit {corpus.n} vectors "
                         f"({corpus.n_pad} padded)")
    return HNSWIndex.from_state(corpus, state, **index_kwargs)

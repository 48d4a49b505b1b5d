"""Carry a built index across from the JAX package.

A graph is this system's counterpart of a model's weights: serving cannot
run without one. ``from_reference`` takes what an index of ``hnsw_tpu/``
returns from ``to_state()`` (numpy arrays and params: for HNSW ``levels``,
``adj0``, ``adj_upper``, ``entry``, ...; for partitioned HNSW ``rows_p``,
``adj0_p``, ...; for IVF-HNSW ``centroids``, ``medoids``, ``adj0``, ...)
together with the vectors the index was built on, packs the vectors into
the same ``Corpus`` layout, and returns the port's index of that family over
the identical graph. It reads plain numpy and imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hnsw_tpu_torch.models import INDEX_CLASSES
from hnsw_tpu_torch.types import Corpus, Metric


def from_reference(vectors: np.ndarray, state: Dict[str, Any], *,
                   metric: "Metric | str", device, family: str = "hnsw",
                   **index_kwargs):
    """The port's index of `family` ("hnsw", "partitioned_hnsw" or
    "ivf_hnsw") over `vectors` [n, dim] and the graph in `state`.
    index_kwargs (pack_dim, pack_precision, entry_mode, ...) go to
    HNSWIndex."""
    corpus = Corpus.from_array(np.asarray(vectors, np.float32), metric=metric,
                               device=device)
    arrays = state["arrays"]
    if family == "hnsw":
        n_pad = np.asarray(arrays["adj0"]).shape[0]
        if n_pad != corpus.n_pad or int(state["params"]["n"]) != corpus.n:
            raise ValueError(f"graph of {state['params']['n']} rows "
                             f"({n_pad} padded) does not fit {corpus.n} "
                             f"vectors ({corpus.n_pad} padded)")
        return INDEX_CLASSES[family].from_state(corpus, state,
                                                **index_kwargs)
    rows = np.asarray(arrays["rows_p"] if family == "partitioned_hnsw"
                      else arrays["medoids"])
    if rows.size and int(rows.max()) >= corpus.n:
        raise ValueError(f"state names row {int(rows.max())} of "
                         f"{corpus.n} vectors")
    return INDEX_CLASSES[family].from_state(corpus, state)

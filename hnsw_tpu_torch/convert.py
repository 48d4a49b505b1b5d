"""Carry a built index across from the JAX package.

A graph is this system's counterpart of a model's weights: serving cannot
run without one. ``from_reference`` takes what an index of ``hnsw_tpu/``
returns from ``to_state()`` (numpy arrays and params: for HNSW ``levels``,
``adj0``, ``adj_upper``, ``entry``, ...; for partitioned HNSW ``rows_p``,
``adj0_p``, ..., and ``vectors_p`` / ``v_sq_p`` when the caller adds them
(the JAX index holds them, its ``to_state()`` leaves them out); for
IVF-HNSW ``centroids``, ``medoids``, ``adj0``, ...; for IVF-FLAT and
Lightning the partition table's ``perm``, ``starts``,
``lens`` and ``centroids``; for LSH ``proj`` and ``buckets``; for PCAF
``proj``) together with the vectors the index was built on, packs the
vectors into the same ``Corpus`` layout, and returns the port's index of
that family over the identical graph, table, buckets or projection. It
reads plain numpy and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hnsw_tpu_torch.models import INDEX_CLASSES
from hnsw_tpu_torch.types import Corpus, Metric


def from_reference(vectors: np.ndarray, state: Dict[str, Any], *,
                   metric: "Metric | str", device, family: str = "hnsw",
                   **index_kwargs):
    """The port's index of `family` (a family name of INDEX_CLASSES, or
    "lsh") over `vectors` [n, dim] and the graph, table, buckets or
    projection in `state`. index_kwargs (pack_dim, pack_precision,
    entry_mode, ...) go to HNSWIndex."""
    corpus = Corpus.from_array(np.asarray(vectors, np.float32), metric=metric,
                               device=device)
    arrays = state["arrays"]
    family = "hybrid_lsh" if family == "lsh" else family
    if family in ("ivf_flat", "lightning"):
        _check_table(arrays, int(state["params"]["cmax"]), corpus.n)
        return INDEX_CLASSES[family].from_state(corpus, state)
    if family == "hybrid_lsh":
        buckets = np.asarray(arrays["buckets"])
        if buckets.size and int(buckets.max()) >= corpus.n:
            raise ValueError(f"buckets name row {int(buckets.max())} of "
                             f"{corpus.n} vectors")
        return INDEX_CLASSES[family].from_state(corpus, state)
    if family == "pcaf":
        rows = np.asarray(arrays["proj"]).shape[0]
        if rows != corpus.d_pad:
            raise ValueError(f"projection of {rows} rows does not fit "
                             f"{corpus.d_pad} padded dims")
        return INDEX_CLASSES[family].from_state(corpus, state)
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
    if family == "partitioned_hnsw" and "vectors_p" in arrays:
        want = rows.shape + (corpus.d_pad,)
        if np.shape(arrays["vectors_p"]) != want or \
                np.shape(arrays.get("v_sq_p")) != rows.shape:
            raise ValueError(f"vectors_p / v_sq_p of shapes "
                             f"{np.shape(arrays['vectors_p'])} / "
                             f"{np.shape(arrays.get('v_sq_p'))} do not fit "
                             f"rows_p {rows.shape} at {corpus.d_pad} dims")
    return INDEX_CLASSES[family].from_state(corpus, state)


def _check_table(arrays, cmax: int, n: int) -> None:
    """The table's layout: m = sum(lens) slab rows naming rows of the
    corpus, then cmax guard rows of -1; each slab starts[c] + lens[c] lies
    inside the m rows."""
    perm = np.asarray(arrays["perm"])
    starts = np.asarray(arrays["starts"]).astype(np.int64)
    lens = np.asarray(arrays["lens"]).astype(np.int64)
    m = perm.shape[0] - cmax
    if perm.size and int(perm.max()) >= n:
        raise ValueError(f"table names row {int(perm.max())} of {n} vectors")
    if m < 0 or (perm[:m] < 0).any() or (perm[m:] != -1).any() or \
            (starts < 0).any() or (lens < 0).any() or \
            int((starts + lens).max(initial=0)) > m or int(lens.sum()) != m:
        raise ValueError(f"slabs (starts, lens) do not fit a table of "
                         f"{perm.shape[0]} rows with {cmax} guard rows")

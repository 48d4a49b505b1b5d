"""Unified index protocol (copy of ``hnsw_tpu/models/base.py``).

Mirrors the reference's protocol layer (src/hnsw/api/protocol.clj):
`ANNIndex` (search-knn*/index-info*/index-type*; protocol.clj:9-28) plus the
optional capability protocols — BatchSearchIndex (:58-67; native here, batch
is the TPU fast path rather than a sequential-map default), FilterableIndex
(:34-41; default = over-fetch 3k then post-filter, protocol.clj:97-102),
PersistableIndex (:43-56).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from hnsw_tpu_torch.config import Mode
from hnsw_tpu_torch.types import Corpus, SearchResult


def _np(x) -> np.ndarray:
    """Host copy of a result tensor (or array)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ANNIndex(abc.ABC):
    """Base class for all index families."""

    #: family name, e.g. "hnsw" — the analogue of index-type* (protocol.clj:24-27)
    family: str = "base"

    def __init__(self, corpus: Corpus):
        self.corpus = corpus

    # ---- core protocol -------------------------------------------------

    @abc.abstractmethod
    def search_batch(
        self, queries, k: int, mode: Mode = Mode.BALANCED
    ) -> tuple:
        """Batched device search. queries: [B, dim] host array or tensor.
        Returns (distances float32[B, k], rows int32[B, k]) with rows == -1
        for missing results (e.g. k > n). Ascending by distance."""

    @abc.abstractmethod
    def index_info(self) -> Dict[str, Any]:
        """Stats map — the analogue of index-info* (protocol.clj:19-22)."""

    # ---- persistence hooks (PersistableIndex, protocol.clj:43-56) ------

    def to_state(self) -> Dict[str, Any]:
        """Arrays + params for serialization."""
        raise NotImplementedError(f"{self.family} does not support persistence")

    # ---- derived API ---------------------------------------------------

    @property
    def index_type(self) -> str:
        return self.family

    def search(self, query, k: int = 10, mode: Mode = Mode.BALANCED) -> List[dict]:
        """Single-query convenience: returns [{'id':…, 'distance':…}, …]
        ascending, the reference's result shape (ivf_flat.clj:291-294)."""
        q = np.asarray(query, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        dists, rows = self.search_batch(q, k, mode)
        return self._to_result(_np(dists)[0], _np(rows)[0]).to_dicts()

    def search_many(self, queries, k: int = 10, mode: Mode = Mode.BALANCED
                    ) -> List[List[dict]]:
        """BatchSearchIndex (protocol.clj:58-67) — natively batched."""
        dists, rows = self.search_batch(np.atleast_2d(np.asarray(queries, np.float32)),
                                        k, mode)
        dists, rows = _np(dists), _np(rows)
        return [self._to_result(dists[i], rows[i]).to_dicts()
                for i in range(rows.shape[0])]

    def search_filtered(
        self, query, k: int, predicate: Callable[[Any], bool],
        mode: Mode = Mode.BALANCED, overfetch: int = 3,
    ) -> List[dict]:
        """FilterableIndex default: over-fetch overfetch*k candidates then
        post-filter by predicate on the external id (protocol.clj:97-102)."""
        fetch = min(max(overfetch * k, k), self.corpus.n)
        hits = self.search(query, fetch, mode)
        out = [h for h in hits if predicate(h["id"])]
        return out[:k]

    def _to_result(self, dists: np.ndarray, rows: np.ndarray) -> SearchResult:
        ids = self.corpus.row_ids_to_external(rows)
        return SearchResult(ids=ids, distances=dists, rows=rows)

    # ---- capability predicates (protocol.clj:73-86) --------------------

    @property
    def supports_batch(self) -> bool:
        return True

    @property
    def supports_filter(self) -> bool:
        return True

    @property
    def supports_persistence(self) -> bool:
        """True only when the full save/load round-trip is wired for this
        family: to_state is overridden somewhere, a from_state constructor
        exists, and the family name is registered for load dispatch
        (a loader resolves `INDEX_CLASSES[header["family"]]`). A mere
        `to_state` override is not enough — a future subclass inheriting an
        ancestor's to_state without registration would otherwise claim
        support that `load_index` cannot deliver."""
        cls = type(self)
        if cls.to_state is ANNIndex.to_state or \
                not callable(getattr(cls, "from_state", None)):
            return False
        try:
            from hnsw_tpu_torch.models import INDEX_CLASSES
        except Exception:
            return False
        # EXACT registration check (`cls is registered`): a subclass merely
        # inheriting a registered family name would save fine but load back
        # as the registered base class, losing its type and any extra
        # to_state params — not a supported round-trip, so it reports False.
        return cls is INDEX_CLASSES.get(self.family)

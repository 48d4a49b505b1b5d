"""Simple stateful API. Counterpart of ``hnsw_tpu/api/simple.py``: a mutable
index with string ids and per-id metadata. Adds are buffered and flushed
before the next search, info or save: the first flush builds the family,
later ones grow an HNSW index by one wave insert and rebuild the other
families. ``save`` stores the metadata with the index, and ``load`` restores
it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from hnsw_tpu_torch.config import Mode
from hnsw_tpu_torch.io.persist import load_index as _load, save_index as _save
from hnsw_tpu_torch.models import FAMILIES
from hnsw_tpu_torch.models.hnsw import HNSWIndex


class Index:
    """Stateful index with string ids and per-id metadata. opts go to the
    family's builder (device= included: the CUDA card by default)."""

    def __init__(self, dimensions: Optional[int] = None,
                 distance: str = "cosine", index_type: str = "hnsw", **opts):
        self.dimensions = dimensions
        self.distance = str(distance).lstrip(":").lower()
        self.index_kind = str(index_type).lstrip(":").lower().replace("-", "_")
        self.opts = opts
        self.metadata: Dict[str, Any] = {}
        self._pending: List[tuple] = []      # (id, vector)
        self._impl = None

    # ---- mutation ------------------------------------------------------

    def add(self, item_id, vector, metadata: Optional[dict] = None) -> str:
        """Buffer one vector; returns the normalized string id."""
        vector = np.asarray(vector, np.float32)
        if self.dimensions is None:
            self.dimensions = int(vector.shape[-1])
        elif vector.shape[-1] != self.dimensions:
            raise ValueError(
                f"vector dim {vector.shape[-1]} != index dim {self.dimensions}")
        sid = str(item_id)
        self._pending.append((sid, vector))
        if metadata is not None:
            self.metadata[sid] = metadata
        return sid

    add_ = add  # spelling alias for the reference's add!

    def add_batch(self, items) -> List[str]:
        """items: iterable of (id, vector) or (id, vector, metadata)."""
        return [self.add(*it) for it in items]

    def _flush(self):
        if not self._pending:
            return
        ids = [p[0] for p in self._pending]
        vecs = np.stack([p[1] for p in self._pending])
        self._pending.clear()
        if self._impl is None:
            self._impl = FAMILIES[self.index_kind](
                vecs, metric=self.distance, ids=ids, **self.opts)
        elif isinstance(self._impl, HNSWIndex):
            self._impl.add_batch(vecs, ids=ids)
        else:
            # the other families rebuild over old + new rows
            corpus = self._impl.corpus
            old = corpus.vectors[: corpus.n, : corpus.dim].cpu().numpy()
            old_ids = list(corpus.ids) if corpus.ids is not None else \
                [str(i) for i in range(corpus.n)]
            self._impl = FAMILIES[self.index_kind](
                np.concatenate([old, vecs]), metric=self.distance,
                ids=old_ids + ids, **self.opts)

    # ---- queries -------------------------------------------------------

    def search(self, vector, k: int = 10, mode: Mode = Mode.BALANCED
               ) -> List[dict]:
        """Hits [{'id', 'distance', 'metadata'?}, ...], ascending."""
        self._flush()
        if self._impl is None:
            return []
        hits = self._impl.search(vector, k, mode)
        for h in hits:
            md = self.metadata.get(h["id"])
            if md is not None:
                h["metadata"] = md
        return hits

    def info(self) -> Dict[str, Any]:
        self._flush()
        base = {"dimensions": self.dimensions, "distance_type": self.distance,
                "index_type": self.index_kind,
                "size": self._impl.corpus.n if self._impl else 0}
        if self._impl is not None:
            base.update(self._impl.index_info())
        return base

    @property
    def size(self) -> int:
        self._flush()
        return self._impl.corpus.n if self._impl else 0

    # ---- persistence ---------------------------------------------------

    def save(self, path: str, *, format: str = "npz") -> str:
        """Persist the index with its per-id metadata table. format="dir"
        writes the mmap-loadable layout."""
        self._flush()
        if self._impl is None:
            raise ValueError("cannot save an empty index")
        return _save(self._impl, path, metadata=self.metadata or None,
                     format=format)

    @classmethod
    def load(cls, path: str, metadata: Optional[Dict[str, Any]] = None,
             device=None) -> "Index":
        """Load a saved index onto `device` (the CUDA card by default);
        stored metadata is restored (a `metadata` argument overrides stored
        entries), and later adds stay on the same device."""
        impl, saved_meta = _load(path, return_metadata=True, device=device)
        out = cls(dimensions=impl.corpus.dim,
                  distance=impl.corpus.metric.value,
                  index_type=impl.family, device=impl.corpus.device)
        out._impl = impl
        out.metadata = {**saved_meta, **(metadata or {})}
        return out

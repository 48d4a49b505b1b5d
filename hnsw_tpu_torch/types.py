"""Core data types: metrics, the packed corpus substrate, search results.

PyTorch counterpart of ``hnsw_tpu/types.py``. Every index family shares one
device-resident packed matrix ``float32[N_pad, D_pad]`` plus precomputed
squared norms, with int64/int32 row ids internally and a string-id table at
the API edge. Rows are padded to 8 and dimensions to 128, the same layout as
the JAX package, so results index the same rows in both.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
on a host without a card, leaving ``device`` out raises (``resolve_device``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence

import numpy as np
import torch


class Metric(str, enum.Enum):
    """Distance metrics, ascending-better: cosine -> 1 - cos_sim,
    euclidean -> L2, dot -> -dot."""

    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    DOT = "dot"

    @classmethod
    def coerce(cls, m: "Metric | str") -> "Metric":
        if isinstance(m, Metric):
            return m
        key = str(m).lstrip(":").lower()
        aliases = {"l2": "euclidean", "angular": "cosine", "ip": "dot",
                   "inner-product": "dot", "inner_product": "dot"}
        return cls(aliases.get(key, key))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Column padding of the packed corpus (kept from the JAX layout so both
# packages index identical [N_pad, D_pad] arrays).
LANE = 128
# Row padding granularity.
SUBLANE = 8


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hnsw_tpu_torch runs on a CUDA device unless told otherwise, "
                "and torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the host")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class Corpus:
    """Packed, padded corpus: the substrate every index family builds on.

    Attributes:
      vectors:  float32[N_pad, D_pad] tensor — rows >= n are zero padding.
      sq_norms: float32[N_pad] tensor — squared L2 norms (0 for padding).
      n:        number of real rows.
      dim:      real dimensionality (D_pad >= dim, zero-padded columns).
      metric:   default metric for indexes built on this corpus.
      ids:      optional external string ids, host-side (length n).
    """

    vectors: torch.Tensor
    sq_norms: torch.Tensor
    n: int
    dim: int
    metric: Metric = Metric.COSINE
    ids: Optional[np.ndarray] = None

    @property
    def n_pad(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def d_pad(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @classmethod
    def from_array(
        cls,
        data: np.ndarray,
        *,
        metric: "Metric | str" = Metric.COSINE,
        ids: Optional[Sequence[Any]] = None,
        pad_rows_to: int = SUBLANE,
        device=None,
    ) -> "Corpus":
        """Pack a host array [n, dim] into the padded device layout."""
        dev = resolve_device(device)
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ValueError(f"expected [n, dim] array, got shape {data.shape}")
        n, dim = data.shape
        n_pad = round_up(max(n, 1), pad_rows_to)
        d_pad = round_up(dim, LANE)
        packed = np.zeros((n_pad, d_pad), dtype=np.float32)
        packed[:n, :dim] = data
        vectors = torch.from_numpy(packed).to(dev)
        sq_norms = torch.sum(vectors * vectors, dim=-1)
        id_table = None
        if ids is not None:
            if len(ids) != n:
                raise ValueError(f"{len(ids)} ids for {n} vectors")
            id_table = np.asarray([str(i) for i in ids], dtype=object)
        return cls(vectors=vectors, sq_norms=sq_norms, n=n, dim=dim,
                   metric=Metric.coerce(metric), ids=id_table)

    @classmethod
    def from_array_streamed(
        cls,
        data,
        *,
        metric: "Metric | str" = Metric.COSINE,
        ids: Optional[Sequence[Any]] = None,
        pad_rows_to: int = SUBLANE,
        chunk_rows: int = 65536,
        device=None,
    ) -> "Corpus":
        """Pack a host array (e.g. a numpy memmap) into the device layout
        WITHOUT materializing a full host copy: rows are padded and copied
        to `device` in `chunk_rows` chunks, straight into the device matrix.
        Transient host memory is one chunk."""
        if getattr(data, "ndim", 2) != 2:
            raise ValueError(f"expected [n, dim] array, got {data.shape}")
        n, dim = data.shape
        if n <= chunk_rows:
            return cls.from_array(np.asarray(data, np.float32), metric=metric,
                                  ids=ids, pad_rows_to=pad_rows_to,
                                  device=device)
        dev = resolve_device(device)
        n_pad = round_up(n, pad_rows_to)
        d_pad = round_up(dim, LANE)
        vectors = torch.empty((n_pad, d_pad), dtype=torch.float32, device=dev)
        for s in range(0, n_pad, chunk_rows):
            rows = min(chunk_rows, n_pad - s)
            block = np.zeros((rows, d_pad), np.float32)
            real = max(min(n - s, rows), 0)
            if real:
                block[:real, :dim] = data[s: s + real]
            vectors[s: s + rows] = torch.from_numpy(block).to(dev)
        sq_norms = torch.sum(vectors * vectors, dim=-1)
        id_table = None
        if ids is not None:
            if len(ids) != n:
                raise ValueError(f"{len(ids)} ids for {n} vectors")
            id_table = np.asarray([str(i) for i in ids], dtype=object)
        return cls(vectors=vectors, sq_norms=sq_norms, n=n, dim=dim,
                   metric=Metric.coerce(metric), ids=id_table)

    @classmethod
    def from_pairs(cls, pairs: Sequence[tuple], **kw) -> "Corpus":
        """Build from a sequence of ``[id, vector]`` pairs."""
        ids = [p[0] for p in pairs]
        data = np.asarray([np.asarray(p[1], dtype=np.float32) for p in pairs])
        return cls.from_array(data, ids=ids, **kw)

    def row_ids_to_external(self, rows: np.ndarray) -> np.ndarray:
        """Map internal int rows to external string ids (identity if none)."""
        rows = np.asarray(rows)
        if self.ids is None:
            return rows
        flat = rows.reshape(-1)
        out = np.empty(flat.shape, dtype=object)
        valid = (flat >= 0) & (flat < self.n)
        out[valid] = self.ids[flat[valid].astype(np.int64)]
        out[~valid] = None
        return out.reshape(rows.shape)

    def pad_queries(self, queries) -> torch.Tensor:
        """Pad queries [..., dim] to [..., d_pad] float32 on the corpus
        device. Tensors already on the device pass without a host trip."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
            if q.ndim == 1:
                q = q[None, :]
            if q.shape[-1] == self.d_pad:
                return q
            if q.shape[-1] != self.dim:
                raise ValueError(
                    f"query dim {q.shape[-1]} != corpus dim {self.dim}")
            return torch.nn.functional.pad(q, (0, self.d_pad - self.dim))
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[-1] != self.dim:
            raise ValueError(f"query dim {q.shape[-1]} != corpus dim {self.dim}")
        if q.shape[-1] != self.d_pad:
            padw = [(0, 0)] * (q.ndim - 1) + [(0, self.d_pad - q.shape[-1])]
            q = np.pad(q, padw)
        return torch.from_numpy(np.ascontiguousarray(q)).to(self.device)


@dataclasses.dataclass
class SearchResult:
    """One query's k results, ascending by distance."""

    ids: np.ndarray        # external ids (or int rows) [k]
    distances: np.ndarray  # float32 [k]
    rows: np.ndarray       # internal int rows [k] (-1 = no result)

    def to_dicts(self):
        out = []
        for i in range(len(self.rows)):
            if int(self.rows[i]) < 0:
                continue
            out.append({"id": self.ids[i], "distance": float(self.distances[i])})
        return out

    def __len__(self):
        return int(np.sum(np.asarray(self.rows) >= 0))

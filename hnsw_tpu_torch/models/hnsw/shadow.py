"""What the hop loop scores against (its precision, the bf16 shadow or
PCA projection, the neighbour pack), decided here alone for HNSWIndex,
IVF-HNSW, partitioned HNSW and the wave insert."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hnsw_tpu_torch.models.hnsw.search import (pack_neighbors,
                                               pack_neighbors_int8)
from hnsw_tpu_torch.types import Metric, round_up
from hnsw_tpu_torch.utils import tracing

# the pack holds each row once per in-edge; it is built while it fits
PACK_BYTES_CAP = 6 << 30


def loop_precision(metric, precision: str = "auto") -> str:
    """"auto": bf16-class loop scoring ("default") for cosine, f32
    ("highest") otherwise, as the euclidean norm formula cancels at bf16."""
    if precision != "auto":
        return precision
    return "default" if Metric.coerce(metric) == Metric.COSINE else "highest"


class HopRoute(NamedTuple):
    """_search_batch's precision, vectors_lp, nbr_pack, nbr_sq, nbr_scale
    and v_sq_lp (`kwargs`, None if left out), the queries' projection, the
    parts of a captured search's key they fix, and whether they were built."""
    precision: str
    pack: Optional[str]
    loop_dim: int
    rebuilt: bool
    kwargs: dict
    proj: Optional[torch.Tensor]


class HopShadow:
    """Built at first use, kept while the corpus's vectors, the adjacency
    (the same tensors) and the settings stay the same."""

    def __init__(self):
        self.proj = self.vectors_lp = self.v_sq_lp = None
        self.nbr_pack = self.nbr_sq = self.nbr_scale = None
        self._of = self._pack_of = (None, None)

    def prepare(self, corpus, adj0, *, precision="auto", pack="auto",
                pack_precision="auto", pack_dim: Optional[int] = None,
                cap: int = PACK_BYTES_CAP) -> HopRoute:
        """The operands of a search under HNSWIndex's settings. An f32 loop
        needs no shadow and no pack. pack_dim: score hops against the top
        pack_dim PCA axes; pack: "auto" (while it fits `cap`), True or
        False; pack_precision: "bf16", "int8" (per-row quantized codes and
        scales, half the bytes) or "auto" (bf16 while it fits `cap`).
        Records the span hnsw.pack (attributes precision and bytes: the
        codes or rows, the norms and any scales) where it builds a pack."""
        precision = loop_precision(corpus.metric, precision)
        vectors = corpus.vectors
        if precision == "highest":
            return HopRoute(precision, None, vectors.shape[1], False,
                            dict(precision=precision), None)
        if pack_dim is not None and pack_dim >= vectors.shape[1]:
            pack_dim = None
        rebuilt = self._of[0] is not vectors or self._of[1] != pack_dim
        if rebuilt:
            self._build_shadow(vectors, pack_dim)
        loop_dim = self.vectors_lp.shape[1]
        rows = adj0.shape[0] * adj0.shape[1]
        pp = pack_precision
        if pp == "auto":
            pp = "bf16" if rows * (loop_dim * 2 + 4) <= cap else "int8"
        nbytes = rows * (loop_dim * 2 + 4 if pp == "bf16" else loop_dim + 8)
        use_pack = pack is True or (pack == "auto" and nbytes <= cap)
        if use_pack and (self._pack_of[0] is not adj0
                         or self._pack_of[1] != pp):
            sq = corpus.sq_norms if self.v_sq_lp is None else self.v_sq_lp
            with tracing.span("hnsw.pack", precision=pp, bytes=nbytes):
                if pp == "int8":
                    self.nbr_pack, self.nbr_scale, self.nbr_sq = \
                        pack_neighbors_int8(self.vectors_lp, sq, adj0)
                else:
                    self.nbr_scale = None
                    self.nbr_pack, self.nbr_sq = pack_neighbors(
                        self.vectors_lp, sq, adj0)
            self._pack_of, rebuilt = (adj0, pp), True
        kw = dict(precision=precision, vectors_lp=self.vectors_lp,
                  v_sq_lp=self.v_sq_lp)
        if use_pack:
            kw.update(nbr_pack=self.nbr_pack, nbr_sq=self.nbr_sq,
                      nbr_scale=self.nbr_scale)
        return HopRoute(precision, pp if use_pack else None, loop_dim,
                        rebuilt, kw, self.proj)

    def _build_shadow(self, vectors, pack_dim):
        """The bf16 shadow, or the projection on the top pack_dim principal
        axes (a [D, D] product on the device, a host eigh), with zero
        columns up to a multiple of 16: the hop kernels and the descent
        take no other width, and zeros add nothing to products or norms."""
        self.__init__()                 # the pack goes with the shadow
        if pack_dim is None:
            self.vectors_lp = vectors.to(torch.bfloat16)
        else:
            _, v = np.linalg.eigh(torch.matmul(vectors.T, vectors).cpu()
                                  .numpy())       # ascending eigenvalues
            basis = np.zeros((v.shape[0], round_up(pack_dim, 16)), v.dtype)
            basis[:, :pack_dim] = v[:, ::-1][:, :pack_dim]
            self.proj = torch.from_numpy(basis).to(vectors.device)
            self.vectors_lp = torch.matmul(vectors, self.proj).to(
                torch.bfloat16)
            vf = self.vectors_lp.float()
            self.v_sq_lp = torch.sum(vf * vf, dim=-1)
        self._of = (vectors, pack_dim)

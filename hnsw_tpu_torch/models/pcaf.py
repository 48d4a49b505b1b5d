"""PCAF: a projection coarse filter + exact re-rank. Counterpart of
``hnsw_tpu/models/pcaf.py``.

The corpus is projected once at build onto ``n_components`` directions
(``basis="pca"``: the top principal components, from an f32 covariance
product and ``numpy.linalg.eigh`` on the host; ``basis="random"``: the
reference's seeded Gaussian, scaled by 1/sqrt(n_components)). Search is two
phases: an exact cosine scan of the projected corpus (``flat.exact_topk``)
picks max(k, min(k_filter, 3k)) candidates, and ``gather_score`` re-ranks
them with the exact distance in the original space.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import PCAF_KFILTER, Mode
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.flat import exact_topk
from hnsw_tpu_torch.ops.distance import BIG, gather_score
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Corpus, Metric, round_up


class PCAFIndex(ANNIndex):
    family = "pcaf"

    def __init__(self, corpus: Corpus, *, proj, n_components: int,
                 low_vectors=None, low_sq=None, seed: int = 42):
        """low_vectors / low_sq (the projected corpus and its squared
        norms) are computed from proj when absent."""
        super().__init__(corpus)
        self.proj = proj                                  # [D_pad, C_pad]
        if low_vectors is None:
            low_vectors = torch.matmul(corpus.vectors, proj)
        if low_sq is None:
            low_sq = torch.sum(low_vectors * low_vectors, dim=-1)
        self.low_vectors = low_vectors                    # [N_pad, C_pad]
        self.low_sq = low_sq                              # [N_pad]
        self.n_components = n_components
        self.seed = seed

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     k_filter: Optional[int] = None):
        q = self.corpus.pad_queries(queries)
        mode = Mode.coerce(mode)
        kf = k_filter or PCAF_KFILTER[mode]
        # the reference caps candidates at min(k-filter, 3k); keep >= k so
        # that the re-rank always has enough
        n_cand = max(k, min(kf, 3 * k))
        n_cand = min(n_cand, max(self.corpus.n, 1))

        q_low = torch.matmul(q, self.proj)
        # phase 1: coarse scan in the projected space (cosine)
        _, cand = exact_topk(self.low_vectors, self.low_sq, q_low,
                             k=n_cand, n=self.corpus.n, metric=Metric.COSINE)
        # phase 2: exact re-rank in the original space
        valid = cand >= 0
        d = gather_score(q, cand.clamp(min=0), self.corpus.vectors,
                         self.corpus.sq_norms, metric=self.corpus.metric,
                         valid=valid)
        kk = min(k, d.shape[-1])
        dk, sel = top_k_ascending(d, kk)
        rk = torch.where(dk < BIG, torch.gather(cand, -1, sel), -1)
        if kk < k:
            dk = torch.nn.functional.pad(dk, (0, k - kk), value=BIG)
            rk = torch.nn.functional.pad(rk, (0, k - kk), value=-1)
        return dk, rk

    def index_info(self) -> Dict[str, Any]:
        return {
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
            "n_components": self.n_components,
            "compression_ratio": self.corpus.dim / max(self.n_components, 1),
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "params": {"n_components": self.n_components, "seed": self.seed},
            "arrays": {"proj": self.proj.cpu().numpy()},
        }

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any]) -> "PCAFIndex":
        """The projected corpus is recomputed from the saved proj."""
        p, a = state["params"], state["arrays"]
        proj = torch.from_numpy(np.array(a["proj"], np.float32)) \
            .to(corpus.device)
        return cls(corpus, proj=proj, n_components=int(p["n_components"]),
                   seed=int(p.get("seed", 42)))


def build_pcaf_index(
    data,
    *,
    n_components: int = 100,   # reference default
    metric="cosine",
    ids=None,
    seed: int = 42,
    basis: str = "pca",        # "pca" (default) | "random" (reference parity)
    device=None,
    **_ignored,
) -> PCAFIndex:
    """The projection and the projected corpus, on the CUDA card unless
    device says otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    c_pad = round_up(max(n_components, 1), 128)
    proj = np.zeros((corpus.d_pad, c_pad), np.float32)
    if basis == "pca" and corpus.n > 1:
        # a PCA basis (the reference is named for PCA but ships a random
        # projection): embedding corpora are low-rank, so the principal
        # subspace keeps neighbour order far better at the same width
        cov = torch.matmul(corpus.vectors.T, corpus.vectors).cpu().numpy()
        _, v = np.linalg.eigh(cov)                 # ascending eigenvalues
        proj[:, :n_components] = v[:, ::-1][:, :n_components]
    else:
        rng = np.random.default_rng(seed)
        # padding columns stay zero: the projected space has exactly
        # n_components live dims
        proj[: corpus.dim, : n_components] = (
            rng.standard_normal((corpus.dim, n_components))
            .astype(np.float32) / np.sqrt(n_components))
    return PCAFIndex(corpus, proj=torch.from_numpy(proj).to(corpus.device),
                     n_components=n_components, seed=seed)

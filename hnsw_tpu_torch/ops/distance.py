"""Distance scoring: a query-block x corpus-block product combined with
precomputed squared norms. PyTorch counterpart of ``hnsw_tpu/ops/distance.py``.

Distances are ascending-better:
  cosine    -> 1 - dot / (|q||v|)       in [0, 2]
  euclidean -> sqrt(|q|^2 + |v|^2 - 2 dot)
  dot       -> -dot

Precision. The JAX package asks for bf16 operands with f32 products
(``preferred_element_type=float32``) on its fast paths and for true f32
(``Precision.HIGHEST``) on its exact paths. ``torch.matmul`` on bf16 returns
bf16, which would round every dot to 8 bits, so ``bf16_matmul`` rounds the
operands to bf16 and multiplies them as f32: each product of two bf16 values
is exact in f32 and the sum is accumulated in f32. The f32 paths rely on TF32
being off, which ``hnsw_tpu_torch/__init__.py`` sets.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.types import Metric

# Large-but-finite sentinel: padding rows / masked candidates sort last but
# never produce NaN/inf arithmetic.
BIG = 1e30
_EPS = 1e-12


def as_bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even, as ``astype`` does) and widen back to
    f32 — an exact widening."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16, products and sums in f32."""
    return torch.matmul(as_bf16_f32(a), as_bf16_f32(b))


def distances_from_dots(dots, q_sq, v_sq, metric: Metric) -> torch.Tensor:
    """Convert a dot-product tile [B, N] + squared norms into distances.

    q_sq: [B] or [B, 1]; v_sq: [N] or [1, N].
    """
    if q_sq.ndim <= 1:
        q_sq = q_sq.reshape(q_sq.shape[0] if q_sq.ndim else 1, 1)
    v_sq = v_sq.reshape(1, -1) if v_sq.ndim == 1 else v_sq
    return _dist_bc(dots, q_sq, v_sq, metric)


def score_block(queries, vectors, v_sq, *, metric: Metric = Metric.COSINE,
                precision: str = "f32") -> torch.Tensor:
    """Fused distance tile: one product + norm combine. Returns [B, N]."""
    if precision == "bf16":
        dots = bf16_matmul(queries, vectors.T)
    else:
        dots = torch.matmul(queries, vectors.T)
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    return distances_from_dots(dots, q_sq, v_sq, metric)


def gather_score(queries, rows, vectors, v_sq, *, metric: Metric,
                 valid=None) -> torch.Tensor:
    """Per-query candidate scoring: gather C rows (already clamped >= 0),
    batched f32 dot against the query. Returns [B, C] distances with invalid
    entries set to BIG."""
    cand = vectors[rows]                                    # [B, C, D]
    dots = torch.einsum("bd,bcd->bc", queries.float(), cand.float())
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    c_sq = v_sq[rows]                                       # [B, C]
    d = _dist_bc(dots, q_sq, c_sq, metric)
    if valid is not None:
        d = torch.where(valid, d, BIG)
    return d


def shadow_score(queries, rows, vectors, v_sq, metric: Metric, valid,
                 q_sq=None) -> torch.Tensor:
    """The HNSW search's gather+dot candidate scoring against `vectors` in
    their own dtype: with a bf16 shadow the query is rounded to bf16 too and
    the products are f32 (exact), as the reference's bf16 einsum with an f32
    result. q_sq [B, 1] defaults to the unrounded queries' squared norms.
    Returns [B, C] distances, BIG where not valid. ops/gather.py: on CUDA
    tensors one launch of its kernel, which reads only the valid rows; on
    CPU tensors the gather, einsum and mask."""
    from hnsw_tpu_torch.ops.gather import hop_gather_score
    return hop_gather_score(queries, rows, vectors, v_sq, metric, valid, q_sq)


def _dist_bc(dots, q_sq, c_sq, metric):
    """distances_from_dots variant where norms broadcast against [B, C]."""
    metric = Metric.coerce(metric)
    if metric == Metric.COSINE:
        denom = torch.sqrt(torch.clamp(q_sq * c_sq, min=_EPS))
        return 1.0 - dots / denom
    if metric == Metric.EUCLIDEAN:
        return torch.sqrt(torch.clamp(q_sq + c_sq - 2.0 * dots, min=0.0))
    if metric == Metric.DOT:
        return -dots
    raise ValueError(f"unknown metric {metric}")


def pairwise_distances(a, b, *, metric: Metric = Metric.COSINE):
    """Small-scale all-pairs distances [A, B] in f32."""
    a_sq = torch.sum(a * a, dim=-1)
    b_sq = torch.sum(b * b, dim=-1)
    dots = torch.matmul(a, b.T)
    return distances_from_dots(dots, a_sq[:, None], b_sq[None, :], metric)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize rows."""
    n = torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True),
                               min=_EPS))
    return x / n

"""The HNSW search's candidate scoring against rows (no neighbour pack):
gather each valid candidate's row and dot it with the query.

Counterpart of no Pallas kernel: the reference's hop body
(``hnsw_tpu/models/hnsw/search.py``, ``_score``) gathers ``vectors[rows]``,
takes an einsum against the query and masks the slots that are not valid,
as XLA ops. On CUDA tensors ``hop_gather_score`` launches the hand-written
kernel in ``csrc/gather.cu``, one block a query that reads only the valid
slots' rows and materialises no [B, C, D] tensor, so a score is one launch;
on CPU tensors it runs the plain version below, ``shadow_score``'s
operators moved out unchanged, which the tests hold against a loop written
out on the contract and ``chip_smoke.py`` holds the kernel against on the
card. The search scores through it wherever it reads rows: the hop body
without a pack, the multi-entry seeds, the first entry and the exact
re-rank.
"""

from __future__ import annotations

import functools

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.distance import BIG, _dist_bc
from hnsw_tpu_torch.types import Metric

_METRIC_CODES = {Metric.COSINE: 0, Metric.EUCLIDEAN: 1, Metric.DOT: 2}


def hop_gather_score_plain(queries, rows, vectors, v_sq, metric, valid,
                           q_sq=None):
    """Plain version of hop_gather_score: the gather, einsum and mask."""
    cand = vectors[rows]                                    # [B, C, D]
    qc = queries.to(cand.dtype).float()
    dots = torch.einsum("bd,bcd->bc", qc, cand.float())
    if q_sq is None:
        q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    d = _dist_bc(dots, q_sq, v_sq[rows], metric)
    return torch.where(valid, d, BIG)


@functools.cache
def _entry(name):
    """The C entry point `name` of gather.cu (built on first use)."""
    return getattr(_cuda.library("gather.cu"), name)


@functools.lru_cache(maxsize=None)
def shared_bytes(d: int, value_bytes: int) -> int:
    """The kernel's dynamic shared memory a block for rows of d values of
    value_bytes bytes, from csrc/gather.cu; 0 where the rows are not whole
    16-byte chunks or a block cannot hold the query."""
    return _entry("hop_gather_score_shared_bytes")(d, value_bytes)


def _check(queries, rows, vectors, v_sq, valid, q_sq):
    """Raise ValueError unless the kernel takes these operands."""
    card = vectors.get_device()          # -1 on the CPU
    named = (("queries", queries), ("rows", rows), ("vectors", vectors),
             ("v_sq", v_sq), ("valid", valid), ("q_sq", q_sq))
    ok = (card >= 0 and vectors.dim() == 2 and vectors.shape[0] > 0
          and vectors.dtype in (torch.float32, torch.bfloat16)
          and queries.dtype == v_sq.dtype == q_sq.dtype == torch.float32
          and rows.dtype in (torch.int32, torch.int64)
          and valid.dtype == torch.bool
          and queries.dim() == rows.dim() == 2
          and queries.shape == (rows.shape[0], vectors.shape[1])
          and valid.shape == rows.shape
          and v_sq.shape == vectors.shape[:1]
          and q_sq.numel() == rows.shape[0]
          and all(t.get_device() == card and t.is_contiguous()
                  for _, t in named)
          and vectors.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0)
    if ok:
        ok = shared_bytes(vectors.shape[1], vectors.element_size()) > 0
    if not ok:
        got = "; ".join(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"contiguous {t.is_contiguous()}" for name, t in named)
        raise ValueError(
            "the gather-score kernel takes queries f32 [B, D], rows int32 or "
            "int64 and valid bool [B, C], vectors f32 or bf16 [N_pad, D] "
            "with rows of whole 16-byte chunks, v_sq f32 [N_pad] and q_sq "
            "f32 of B values, contiguous and 16-byte aligned, on one CUDA "
            "device; got " + got)


def hop_gather_score(queries, rows, vectors, v_sq, metric, valid, q_sq=None):
    """Distances of B queries to C candidate rows each: for slot (b, s),
    ops/distance.py:_dist_bc of the dot of queries[b] (rounded to the rows'
    dtype) with vectors[rows[b, s]] in f32, q_sq[b] and v_sq[rows[b, s]];
    BIG where valid[b, s] is false. queries [B, D], rows [B, C] (already
    clamped >= 0), vectors [N_pad, D] f32 or bf16, v_sq [N_pad], valid
    bool [B, C], q_sq [B, 1] (the unrounded queries' squared norms where
    None). Returns [B, C] f32."""
    operands = (queries, rows, vectors, v_sq, valid)
    if all(t.device.type == "cpu" for t in operands) and (
            q_sq is None or q_sq.device.type == "cpu"):
        return hop_gather_score_plain(queries, rows, vectors, v_sq, metric,
                                      valid, q_sq)
    if q_sq is None:
        q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    _check(queries, rows, vectors, v_sq, valid, q_sq)
    b, c = rows.shape
    n_pad, d = vectors.shape
    out = torch.empty((b, c), dtype=torch.float32, device=vectors.device)
    if b == 0 or c == 0:
        return out
    fn = _entry("hop_gather_score_bf16" if vectors.dtype == torch.bfloat16
                else "hop_gather_score_f32")
    code = fn(queries.data_ptr(), q_sq.data_ptr(), rows.data_ptr(),
              int(rows.dtype == torch.int64), vectors.data_ptr(),
              v_sq.data_ptr(), valid.data_ptr(), out.data_ptr(), b, c, n_pad,
              d, _METRIC_CODES[Metric.coerce(metric)],
              _cuda.stream_ptr(vectors.device))
    _cuda.check(code, "hop_gather_score")
    hop_gather_score.launches += 1
    return out


# launch count: incremented where the kernel is launched, nowhere else
hop_gather_score.launches = 0

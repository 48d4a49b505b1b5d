"""Greedy descent through the upper layers of an HNSW graph.

Counterpart of the reference's ``_greedy_descent``
(``hnsw_tpu/models/hnsw/search.py``), an XLA ``lax.while_loop`` per upper
layer inside the jitted search, not a Pallas kernel. On a CUDA tensor
``greedy_descent`` launches the hand-written kernel in ``csrc/descent.cu``:
one block of four warps a query walks every layer from the top down, so the
search needs no host round trip between steps, and each step has one
dependent round trip to memory. On a CPU tensor it runs the plain version
below, a batch loop that asks the host each step whether any query still
improves; the tests hold it against the JAX function and ``chip_smoke.py``
holds the kernel against it on the card.
"""

from __future__ import annotations

import functools

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.distance import shadow_score
from hnsw_tpu_torch.types import Metric

METRIC_CODES = {Metric.COSINE: 0, Metric.EUCLIDEAN: 1, Metric.DOT: 2}

def _descend_layer(queries, q_sq, cur, cur_d, adj_l, vectors, v_sq, metric,
                   visits, layer):
    """One-probe greedy walk on one upper layer until no neighbour
    improves."""
    improving = torch.ones_like(cur, dtype=torch.bool)
    while bool(improving.any()):
        if visits is not None:
            visits.append((layer, improving.nonzero()[:, 0], cur[improving]))
        nb = adj_l[cur]                                     # [B, M]
        valid = (nb >= 0) & improving[:, None]
        d = shadow_score(queries, torch.clamp(nb, min=0), vectors, v_sq,
                         metric, valid, q_sq=q_sq)
        j = torch.argmin(d, dim=-1, keepdim=True)           # first minimum
        best_d = torch.gather(d, -1, j)[:, 0]
        best_id = torch.gather(nb, -1, j)[:, 0]
        better = (best_d < cur_d) & improving
        cur = torch.where(better, best_id, cur)
        cur_d = torch.where(better, best_d, cur_d)
        improving = better
    return cur, cur_d


def greedy_descent_plain(queries, q_sq, cur, cur_d, adj_upper, vectors,
                         v_sq, metric, visits=None):
    """Plain version of greedy_descent: the batch walk of each layer, top
    down, with a host sync a step. `visits`, a list, receives (layer, the
    queries that score a neighbourhood, the rows they score it at) for every
    step, for the smoke script's steps and byte count."""
    metric = Metric.coerce(metric)
    q_sq = q_sq.reshape(-1, 1)
    for l in range(adj_upper.shape[0] - 1, -1, -1):
        cur, cur_d = _descend_layer(queries, q_sq, cur, cur_d, adj_upper[l],
                                    vectors, v_sq, metric, visits, l)
    return cur, cur_d


def _check(queries, q_sq, cur, cur_d, adj_upper, vectors, v_sq):
    """Raise ValueError unless the kernel takes these operands."""
    card = vectors.get_device()
    b, d = queries.shape if queries.dim() == 2 else (-1, -1)
    ok = (vectors.dtype in (torch.bfloat16, torch.float32)
          and vectors.dim() == 2 and vectors.shape[1] == d > 0
          and (d * vectors.element_size()) % 16 == 0
          and vectors.is_contiguous() and vectors.data_ptr() % 16 == 0
          and queries.dtype == torch.float32 and queries.is_contiguous()
          and queries.data_ptr() % 16 == 0
          and adj_upper.dtype == torch.int32 and adj_upper.dim() == 3
          and adj_upper.shape[1] == vectors.shape[0]
          and adj_upper.is_contiguous()
          and shared_bytes(adj_upper.shape[2], d,
                           vectors.element_size()) > 0
          and v_sq.dtype == torch.float32 and v_sq.numel() == vectors.shape[0]
          and q_sq.dtype == torch.float32 and q_sq.numel() == b
          and cur.dtype == torch.int32 and cur.numel() == b
          and cur_d.dtype == torch.float32 and cur_d.numel() == b
          and all(t.get_device() == card and t.is_contiguous()
                  for t in (queries, q_sq, cur, cur_d, adj_upper, v_sq)))
    if not ok or card < 0:
        got = "; ".join(
            f"{name} {t.dtype} {tuple(t.shape)} on {t.device}, contiguous "
            f"{t.is_contiguous()}" for name, t in (
                ("queries", queries), ("q_sq", q_sq), ("cur", cur),
                ("cur_d", cur_d), ("adj_upper", adj_upper),
                ("vectors", vectors), ("v_sq", v_sq)))
        raise ValueError(
            "the descent kernel takes queries float32 [B, D], q_sq, cur_d "
            "float32 [B], cur int32 [B], adj_upper int32 [L, N_pad, M], "
            "vectors bfloat16 or float32 [N_pad, D] with rows of a multiple "
            "of 16 bytes, v_sq float32 [N_pad], contiguous, on one CUDA "
            "device, and an M whose ids fit a block's shared memory; got "
            + got)


@functools.cache
def _entry(name):
    """The C entry point `name` of descent.cu (built on first use)."""
    return getattr(_cuda.library("descent.cu"), name)


@functools.lru_cache(maxsize=None)
def shared_bytes(m: int, d: int, elem: int) -> int:
    """The kernel's dynamic shared memory a block for M neighbours of rows
    of d values of `elem` bytes, from csrc/descent.cu's own plan; 0 where
    the ids of M neighbours do not fit a block."""
    return _entry("greedy_descent_shared_bytes")(m, d, elem)


def greedy_descent(queries, q_sq, cur, cur_d, adj_upper, vectors, v_sq,
                   metric):
    """Walk every upper layer l = L-1 .. 0 of adj_upper [L, N_pad, M] from
    (cur [B] int32, cur_d [B] f32), each query moving to its neighbourhood's
    first minimum while that is strictly nearer. queries [B, D] f32 are
    rounded to the dtype of vectors [N_pad, D] (bf16 or f32) for the
    products; q_sq [B] comes from the unrounded queries. Returns the new
    (cur, cur_d)."""
    if vectors.device.type == "cpu":
        return greedy_descent_plain(queries, q_sq, cur, cur_d, adj_upper,
                                    vectors, v_sq, metric)
    metric = Metric.coerce(metric)
    queries = queries.contiguous()
    q_sq, cur, cur_d = (t.reshape(-1).contiguous() for t in (q_sq, cur, cur_d))
    _check(queries, q_sq, cur, cur_d, adj_upper, vectors, v_sq)
    layers, n_pad, m = adj_upper.shape
    b, d = queries.shape
    if layers == 0 or b == 0:
        return cur, cur_d
    out_cur = torch.empty_like(cur)
    out_d = torch.empty_like(cur_d)
    name = ("greedy_descent_bf16" if vectors.dtype == torch.bfloat16
            else "greedy_descent_f32")
    code = _entry(name)(
        queries.data_ptr(), q_sq.data_ptr(), cur.data_ptr(), cur_d.data_ptr(),
        adj_upper.data_ptr(), vectors.data_ptr(), v_sq.data_ptr(),
        out_cur.data_ptr(), out_d.data_ptr(), b, layers, n_pad, m, d,
        METRIC_CODES[metric], _cuda.stream_ptr(vectors.device))
    _cuda.check(code, "greedy_descent")
    greedy_descent.launches += 1
    return out_cur, out_d


# launch count: incremented where the kernel is launched, nowhere else
greedy_descent.launches = 0

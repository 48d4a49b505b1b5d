"""Fused gather + score of packed neighbourhoods for the HNSW hop loop.

Counterpart of ``hnsw_tpu/ops/pallas_hop.py``. Each hop of the search
expands E beam entries per query and scores their packed neighbourhood
blocks ``nbr_pack[row]`` ([M0, D]) against the query. On a CUDA tensor the
wrappers launch the hand-written kernels in ``csrc/hop.cu`` (bound by the
bytes of the blocks they read; see the note there); on a CPU tensor they run
the plain PyTorch versions below, which the tests hold against the JAX
kernels and ``chip_smoke.py`` holds the CUDA kernels against.

The TPU version pads the batch to strips of 8 and checks a VMEM budget
(``hop_score_eligible``); the CUDA kernel takes any B, E and M0 and any D
that is a multiple of 16, so it has no eligibility test.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.distance import as_bf16_f32


def _blocks(nbr_pack, sel_rows):
    sel = torch.clamp(sel_rows, min=0).long()
    blocks = nbr_pack[sel].float()                          # [B, E, M0, D]
    b, e, m0, d = blocks.shape
    return blocks.reshape(b, e * m0, d)


def hop_score_plain(nbr_pack, queries, sel_rows):
    """Plain version of hop_score: (dots [B, E*M0], csq [B, E*M0]) f32."""
    blocks = _blocks(nbr_pack, sel_rows)
    q = as_bf16_f32(queries.float())
    dots = torch.einsum("bd,bcd->bc", q, blocks)
    return dots, torch.sum(blocks * blocks, dim=-1)


def hop_score_int8_plain(codes, queries, sel_rows):
    """Plain version of hop_score_int8: raw dots [B, E*M0] f32."""
    q = as_bf16_f32(queries.float())
    return torch.einsum("bd,bcd->bc", q, _blocks(codes, sel_rows))


def _check(pack, queries, sel_rows, dtype):
    _cuda.require(pack.dtype == dtype and pack.ndim == 3,
                  f"pack must be {dtype} [N_pad, M0, D], got {pack.dtype} "
                  f"{tuple(pack.shape)}")
    _cuda.require(queries.dtype == torch.float32 and queries.ndim == 2
                  and queries.shape[1] == pack.shape[2],
                  f"queries must be float32 [B, {pack.shape[2]}], got "
                  f"{queries.dtype} {tuple(queries.shape)}")
    _cuda.require(sel_rows.dtype == torch.int32 and sel_rows.ndim == 2
                  and sel_rows.shape[0] == queries.shape[0],
                  f"sel_rows must be int32 [B, E], got {sel_rows.dtype} "
                  f"{tuple(sel_rows.shape)}")
    _cuda.require(pack.shape[2] % 16 == 0, "D must be a multiple of 16")
    for t in (pack, queries, sel_rows):
        _cuda.require(t.device == pack.device and t.is_cuda,
                      "all tensors must be on one CUDA device")
        _cuda.require(t.is_contiguous(), "tensors must be contiguous")
        _cuda.require(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")


def hop_score(nbr_pack, queries, sel_rows):
    """Fused gather+score of each query's E neighbourhoods.

    nbr_pack [N_pad, M0, D] bf16, queries [B, D] f32 (scored as bf16),
    sel_rows [B, E] int32 (negative rows read row 0).
    Returns (dots [B, E*M0] f32, csq [B, E*M0] f32)."""
    if nbr_pack.device.type == "cpu":
        return hop_score_plain(nbr_pack, queries, sel_rows)
    _check(nbr_pack, queries, sel_rows, torch.bfloat16)
    n_pad, m0, d = nbr_pack.shape
    b, e = sel_rows.shape
    dots = torch.empty((b, e * m0), dtype=torch.float32, device=nbr_pack.device)
    csq = torch.empty_like(dots)
    code = _cuda.library("hop.cu").hop_score_bf16(
        nbr_pack.data_ptr(), queries.data_ptr(), sel_rows.data_ptr(),
        dots.data_ptr(), csq.data_ptr(), b, e, m0, d, n_pad,
        _cuda.stream_ptr(nbr_pack.device))
    _cuda.check(code, "hop_score")
    hop_score.launches += 1
    return dots, csq


def hop_score_int8(codes, queries, sel_rows):
    """Fused gather+score over int8 packed codes. Returns RAW dots
    [B, E*M0] f32 (q . codes, the query rounded to bf16, not quantized);
    the caller multiplies by the per-packed-row scale."""
    if codes.device.type == "cpu":
        return hop_score_int8_plain(codes, queries, sel_rows)
    _check(codes, queries, sel_rows, torch.int8)
    n_pad, m0, d = codes.shape
    b, e = sel_rows.shape
    dots = torch.empty((b, e * m0), dtype=torch.float32, device=codes.device)
    code = _cuda.library("hop.cu").hop_score_int8(
        codes.data_ptr(), queries.data_ptr(), sel_rows.data_ptr(),
        dots.data_ptr(), b, e, m0, d, n_pad, _cuda.stream_ptr(codes.device))
    _cuda.check(code, "hop_score_int8")
    hop_score_int8.launches += 1
    return dots


# launch counts: incremented where a kernel is launched, nowhere else
hop_score.launches = 0
hop_score_int8.launches = 0

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

The hop loop waits on the host every hop, so the card waits through each
wrapper's host work: the checks test one combined condition per tensor and
build a message only when one fails, the outputs of ``hop_score`` are two
views of one allocation, and the C entry points are looked up once.
"""

from __future__ import annotations

import functools

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


def hop_score_int8_plain(nbr_pack, queries, sel_rows):
    """Plain version of hop_score_int8: raw dots [B, E*M0] f32."""
    q = as_bf16_f32(queries.float())
    return torch.einsum("bd,bcd->bc", q, _blocks(nbr_pack, sel_rows))


def _check(pack, queries, sel_rows, dtype):
    """Raise ValueError unless the kernel takes these operands. The passing
    path tests one combined condition per tensor and formats nothing."""
    card = pack.get_device()          # -1 on the CPU
    if not (pack.dtype == dtype and pack.dim() == 3 and card >= 0
            and pack.shape[2] % 16 == 0 and pack.is_contiguous()
            and pack.data_ptr() % 16 == 0) or not (
            queries.dtype == torch.float32 and queries.dim() == 2
            and queries.shape[1] == pack.shape[2]
            and queries.get_device() == card and queries.is_contiguous()
            and queries.data_ptr() % 16 == 0) or not (
            sel_rows.dtype == torch.int32 and sel_rows.dim() == 2
            and sel_rows.shape[0] == queries.shape[0]
            and sel_rows.get_device() == card and sel_rows.is_contiguous()
            and sel_rows.data_ptr() % 16 == 0):
        got = "; ".join(
            f"{name} {t.dtype} {tuple(t.shape)} on {t.device}, contiguous "
            f"{t.is_contiguous()}, address {t.data_ptr():#x}"
            for name, t in (("pack", pack), ("queries", queries),
                            ("sel_rows", sel_rows)))
        raise ValueError(
            f"the hop kernel takes pack {dtype} [N_pad, M0, D] with D a "
            "multiple of 16, queries float32 [B, D] and sel_rows int32 "
            "[B, E], contiguous, 16-byte aligned, on one CUDA device; got "
            + got)


@functools.cache
def _entry(name):
    """The C entry point `name` of hop.cu (built on first use)."""
    return getattr(_cuda.library("hop.cu"), name)


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
    dots, csq = nbr_pack.new_empty((2, b, e * m0),
                                   dtype=torch.float32).unbind(0)
    code = _entry("hop_score_bf16")(
        nbr_pack.data_ptr(), queries.data_ptr(), sel_rows.data_ptr(),
        dots.data_ptr(), csq.data_ptr(), b, e, m0, d, n_pad,
        _cuda.stream_ptr(nbr_pack.device))
    _cuda.check(code, "hop_score")
    hop_score.launches += 1
    return dots, csq


def hop_score_int8(nbr_pack, queries, sel_rows):
    """Fused gather+score over int8 packed codes nbr_pack [N_pad, M0, D].
    Returns RAW dots [B, E*M0] f32 (q . codes, the query rounded to bf16,
    not quantized); the caller multiplies by the per-packed-row scale."""
    if nbr_pack.device.type == "cpu":
        return hop_score_int8_plain(nbr_pack, queries, sel_rows)
    _check(nbr_pack, queries, sel_rows, torch.int8)
    n_pad, m0, d = nbr_pack.shape
    b, e = sel_rows.shape
    dots = nbr_pack.new_empty((b, e * m0), dtype=torch.float32)
    code = _entry("hop_score_int8")(
        nbr_pack.data_ptr(), queries.data_ptr(), sel_rows.data_ptr(),
        dots.data_ptr(), b, e, m0, d, n_pad, _cuda.stream_ptr(nbr_pack.device))
    _cuda.check(code, "hop_score_int8")
    # counted on the module's name, as the search reads it; a stand-in put
    # there that counts launches alone (the benchmark's byte counter) keeps
    # no narrow count
    counted = hop_score_int8
    counted.launches += 1
    if int8_lanes(d) < 32 and hasattr(counted, "narrow_launches"):
        counted.narrow_launches += 1
    return dots


@functools.lru_cache(maxsize=None)
def int8_lanes(d: int) -> int:
    """Lanes that share a row of d int8 codes in hop_score_int8's plan, from
    csrc/hop.cu's own: below 32 (D <= 256) a warp-step scores several rows,
    the narrow plan."""
    return _entry("hop_score_int8_lanes")(d)


# the bf16 kernel's dynamic shared memory per block: csrc/hop.cu's ring of
# kStages = 16 stages of kStageBytes = 12,288, a full and an empty mbarrier
# each, and 16 zero bytes (tests/test_torch_hop_plan.py holds it to the
# source)
RING_SMEM_BYTES = 16 * (12288 + 2 * 8) + 16

# launch counts: incremented where a kernel is launched, nowhere else;
# narrow_launches: those of hop_score_int8 that took the narrow plan
hop_score.launches = 0
hop_score_int8.launches = 0
hop_score_int8.narrow_launches = 0

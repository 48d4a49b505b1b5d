"""The beam update of the HNSW hop body: the stable merge of the scored
candidates into the beam, and the next body's select.

Counterpart of no Pallas kernel: the reference's hop body
(``hnsw_tpu/models/hnsw/search.py``) selects the E best unexpanded beam
entries with a cumsum, an amin and a one-hot, and merges the scored
candidates into the beam with one stable ``lax.sort``, as XLA ops. The
select of body i + 1 reads only the beam that body i's merge leaves, so the
two are one step here: ``hop_merge`` merges, then selects on the merged
beam. On CUDA tensors it launches the hand-written kernel in
``csrc/merge.cu``, one block a query, so a body's update is one launch; on
CPU tensors it runs the plain version below, the body's operators moved out
unchanged, which the tests hold against a loop written out on the contract
and ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import functools

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.distance import BIG


def sort_merge(beam_d, beam_i, beam_e, cand_d, cand_i):
    """Top-ef merge of [beam ++ candidates] carrying the (id, expanded)
    payload: one stable sort of the keys carrying (id << 1) | expanded (as
    the reference's one-key ``lax.sort``); -1 ids map to -2/-1 payloads
    whose arithmetic >> 1 restores -1. Candidates enter not expanded."""
    ef = beam_d.shape[-1]
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    all_i = torch.cat([beam_i, cand_i], dim=-1)
    all_e = torch.cat([beam_e, torch.zeros_like(cand_d, dtype=torch.bool)],
                      dim=-1)
    pay = (all_i << 1) | all_e.to(all_i.dtype)
    kd, order = torch.sort(all_d, dim=-1, stable=True)
    kp = torch.gather(pay, -1, order[..., :ef])
    return kd[..., :ef], kp >> 1, (kp & 1) == 1


def select_plain(beam_d, beam_ids, beam_exp, active, e: int):
    """The hop body's select on a beam: the first e eligible (not expanded,
    id >= 0) slots where the query is still active after the stop rule.
    Returns (beam_d, beam_ids, beam_exp with the taken slots set, sel_ids
    int32 [B, e] (-1 past the last taken), active [B])."""
    elig = (~beam_exp) & (beam_ids >= 0)
    # the beam is sorted ascending, so the FIRST e eligible slots are the
    # e best unexpanded candidates: rank-compact them with a cumsum
    pos = torch.cumsum(elig.to(torch.int32), dim=-1) - 1
    sel_d0 = torch.amin(torch.where(elig, beam_d, BIG), dim=-1)
    # serial-equivalent stop rule: best unexpanded > worst beam member
    worst = beam_d[:, -1]
    active = active & (sel_d0 < BIG) & (sel_d0 <= worst)
    take = elig & (pos < e) & active[:, None]
    beam_exp = beam_exp | take
    e_iota = torch.arange(e, dtype=torch.int32, device=beam_d.device)
    onehot = take[:, None, :] & (pos[:, None, :] == e_iota[None, :, None])
    sel_ids = torch.amax(torch.where(onehot, beam_ids[:, None, :], -1),
                         dim=-1)                            # [B, E]
    return beam_d, beam_ids, beam_exp, sel_ids, active


def hop_merge_plain(beam_d, beam_ids, beam_exp, cand_d, cand_ids, active,
                    e: int):
    """Plain version of hop_merge: sort_merge, then select_plain."""
    merged = sort_merge(beam_d, beam_ids, beam_exp, cand_d, cand_ids)
    return select_plain(*merged, active, e)


@functools.cache
def _entry(name):
    """The C entry point `name` of merge.cu (built on first use)."""
    return getattr(_cuda.library("merge.cu"), name)


@functools.lru_cache(maxsize=None)
def shared_bytes(ef: int, c: int) -> int:
    """The kernel's dynamic shared memory a block for a beam of ef and c
    candidates, from csrc/merge.cu; 0 where a block cannot hold it."""
    return _entry("hop_merge_shared_bytes")(ef, c)


def _check(beam_d, beam_ids, beam_exp, cand_d, cand_ids, active, e):
    """Raise ValueError unless the kernel takes these operands."""
    card = beam_d.get_device()          # -1 on the CPU
    named = (("beam_d", beam_d), ("beam_ids", beam_ids),
             ("beam_exp", beam_exp), ("cand_d", cand_d),
             ("cand_ids", cand_ids), ("active", active))
    ok = (card >= 0 and e >= 0 and beam_d.dim() == 2
          and beam_d.shape[1] > 0 and cand_d.dim() == 2
          and beam_d.shape[0] == cand_d.shape[0]
          and beam_d.dtype == cand_d.dtype == torch.float32
          and beam_ids.dtype == cand_ids.dtype == torch.int32
          and beam_exp.dtype == active.dtype == torch.bool
          and beam_ids.shape == beam_exp.shape == beam_d.shape
          and cand_ids.shape == cand_d.shape
          and active.shape == beam_d.shape[:1]
          and all(t.get_device() == card and t.is_contiguous()
                  for _, t in named))
    if ok:
        ok = shared_bytes(beam_d.shape[1], cand_d.shape[1]) > 0
    if not ok:
        got = "; ".join(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"contiguous {t.is_contiguous()}" for name, t in named)
        raise ValueError(
            "the merge kernel takes beam_d f32, beam_ids int32 and beam_exp "
            "bool [B, ef], cand_d f32 and cand_ids int32 [B, C], active bool "
            "[B] and e >= 0, contiguous, on one CUDA device, with an ef + C "
            f"that fits a block's shared memory; got e {e}; " + got)


def hop_merge(beam_d, beam_ids, beam_exp, cand_d, cand_ids, active, e: int):
    """The hop body's beam update: the new beam is the first ef entries of
    the stable ascending sort of [beam ++ candidates] by distance (equal
    distances keep their order, the beam's first; candidates enter not
    expanded; the beam need not be ascending), then the next body's select
    on it (select_plain's). beam_d f32, beam_ids int32, beam_exp bool
    [B, ef]; cand_d f32, cand_ids int32 [B, C] (C may be 0); active bool
    [B]. Returns (beam_d, beam_ids, beam_exp, sel_ids int32 [B, e], active
    [B]), views of one allocation on the card."""
    operands = (beam_d, beam_ids, beam_exp, cand_d, cand_ids, active)
    if all(t.device.type == "cpu" for t in operands):
        return hop_merge_plain(*operands, e)
    _check(*operands, e)
    b, ef = beam_d.shape
    c = cand_d.shape[1]
    buf = torch.empty(b * (ef * 9 + e * 4 + 1), dtype=torch.uint8,
                      device=beam_d.device)
    o_ids, o_sel = b * ef * 4, b * ef * 8
    o_exp = o_sel + b * e * 4
    out_d = buf[:o_ids].view(torch.float32).view(b, ef)
    out_ids = buf[o_ids:o_sel].view(torch.int32).view(b, ef)
    sel_ids = buf[o_sel:o_exp].view(torch.int32).view(b, e)
    out_exp = buf[o_exp:o_exp + b * ef].view(torch.bool).view(b, ef)
    out_active = buf[o_exp + b * ef:].view(torch.bool)
    if b == 0:
        return out_d, out_ids, out_exp, sel_ids, out_active
    code = _entry("hop_merge")(
        *(t.data_ptr() for t in operands), out_d.data_ptr(),
        out_ids.data_ptr(), out_exp.data_ptr(), sel_ids.data_ptr(),
        out_active.data_ptr(), b, ef, c, e, _cuda.stream_ptr(beam_d.device))
    _cuda.check(code, "hop_merge")
    hop_merge.launches += 1
    return out_d, out_ids, out_exp, sel_ids, out_active


# launch count: incremented where the kernel is launched, nowhere else
hop_merge.launches = 0

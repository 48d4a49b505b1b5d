"""The expand phase of the HNSW hop body: adjacency gather, dedupe and
in-beam test.

Counterpart of no Pallas kernel: the reference's hop body
(``hnsw_tpu/models/hnsw/search.py``) gathers ``adj0[sel_ids]``, drops later
duplicates of a row (``_dedupe_row``) and candidates already in the beam as
XLA ops. On a CUDA tensor ``hop_expand`` launches the hand-written kernel in
``csrc/expand.cu``, one block a query with nothing materialised, so a body's
expand is one launch; on CPU tensors it runs the plain version below, those
operators unchanged, which the tests hold against a loop written out on the
contract and ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import functools

import torch

from hnsw_tpu_torch.ops import _cuda


def _dedupe_row(ids, valid):
    """Within-row dedupe: mark later duplicates invalid. ids: [B, C]."""
    eq = ids[:, :, None] == ids[:, None, :]                 # [B, j, i]
    c = ids.shape[-1]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    dup = torch.any(eq & earlier & valid[:, None, :], dim=-1)
    return valid & ~dup


def hop_expand_plain(adj0, sel_ids, beam_ids):
    """Plain version of hop_expand: (cand int32 [B, E*M0], valid bool
    [B, E*M0])."""
    b = sel_ids.shape[0]
    nb = adj0[torch.clamp(sel_ids, min=0)]                  # [B, E, M0]
    nb = torch.where((sel_ids >= 0)[:, :, None], nb, -1).reshape(b, -1)
    valid = _dedupe_row(nb, nb >= 0)
    # drop candidates already in the beam (every node that is or ever was
    # competitive: evicted nodes cannot return)
    in_beam = torch.any(nb[:, :, None] == beam_ids[:, None, :], dim=-1)
    valid = valid & ~in_beam
    return torch.where(valid, nb, -1), valid


@functools.cache
def _entry(name):
    """The C entry point `name` of expand.cu (built on first use)."""
    return getattr(_cuda.library("expand.cu"), name)


@functools.lru_cache(maxsize=None)
def shared_bytes(c: int, ef: int) -> int:
    """The kernel's dynamic shared memory a block for c = E x M0 slots and
    a beam of ef ids, from csrc/expand.cu; 0 where a block cannot hold it."""
    return _entry("hop_expand_shared_bytes")(c, ef)


def _check(adj0, sel_ids, beam_ids):
    """Raise ValueError unless the kernel takes these operands."""
    card = adj0.get_device()          # -1 on the CPU
    ok = (card >= 0 and adj0.dtype == torch.int32 and adj0.dim() == 2
          and adj0.shape[0] > 0 and adj0.is_contiguous()
          and sel_ids.dtype == torch.int32 and sel_ids.dim() == 2
          and beam_ids.dtype == torch.int32 and beam_ids.dim() == 2
          and beam_ids.shape[0] == sel_ids.shape[0]
          and all(t.get_device() == card and t.is_contiguous()
                  for t in (sel_ids, beam_ids)))
    if ok:
        c = sel_ids.shape[1] * adj0.shape[1]
        ok = c == 0 or shared_bytes(c, beam_ids.shape[1]) > 0
    if not ok:
        got = "; ".join(
            f"{name} {t.dtype} {tuple(t.shape)} on {t.device}, contiguous "
            f"{t.is_contiguous()}" for name, t in (
                ("adj0", adj0), ("sel_ids", sel_ids),
                ("beam_ids", beam_ids)))
        raise ValueError(
            "the expand kernel takes adj0 int32 [N_pad, M0], sel_ids int32 "
            "[B, E] and beam_ids int32 [B, ef], contiguous, on one CUDA "
            "device, with E x M0 + ef ids that fit a block's shared memory; "
            "got " + got)


def hop_expand(adj0, sel_ids, beam_ids):
    """The hop body's candidates: for slot s = e * M0 + m of query b, the
    id adj0[sel_ids[b, e], m] (-1 where sel_ids[b, e] < 0), kept where it
    is >= 0, not held by an earlier slot of the row and not among
    beam_ids[b]. adj0 int32 [N_pad, M0], sel_ids int32 [B, E], beam_ids
    int32 [B, ef]. Returns (cand int32 [B, E*M0]: the id where kept, else
    -1; valid bool [B, E*M0]), two views of one allocation on the card."""
    if adj0.device.type == "cpu" and sel_ids.device.type == "cpu" \
            and beam_ids.device.type == "cpu":
        return hop_expand_plain(adj0, sel_ids, beam_ids)
    _check(adj0, sel_ids, beam_ids)
    n_pad, m0 = adj0.shape
    b, e = sel_ids.shape
    c = e * m0
    buf = torch.empty(b * c * 5, dtype=torch.uint8, device=adj0.device)
    cand = buf[:b * c * 4].view(torch.int32).view(b, c)
    valid = buf[b * c * 4:].view(torch.bool).view(b, c)
    if b == 0 or c == 0:
        return cand, valid
    code = _entry("hop_expand")(
        adj0.data_ptr(), sel_ids.data_ptr(), beam_ids.data_ptr(),
        cand.data_ptr(), valid.data_ptr(), b, e, m0, beam_ids.shape[1], n_pad,
        _cuda.stream_ptr(adj0.device))
    _cuda.check(code, "hop_expand")
    hop_expand.launches += 1
    return cand, valid


# launch count: incremented where the kernel is launched, nowhere else
hop_expand.launches = 0

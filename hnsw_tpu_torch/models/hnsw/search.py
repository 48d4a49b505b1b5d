"""Batched HNSW beam search. Counterpart of ``hnsw_tpu/models/hnsw/search.py``.

Every query in a batch advances in lockstep through fixed-shape hops. Each
hop expands the E best not-yet-expanded beam entries, gathers their
fixed-degree adjacency rows, scores all E*M0 neighbours in one fused
gather+dot, and merges into the beam with a stable sort.

Visited-set accounting uses the beam's monotonicity: its worst distance only
ever decreases, so an evicted node can never re-enter it, and per-slot
"expanded" flags carried through the merge replace a visited set.
Termination matches the serial rule (best unexpanded candidate worse than
the worst beam member) per query.

The reference's ``lax.while_loop`` hop loop and greedy descent become Python
loops here, each with one host sync per iteration on ``any(active)``.

With a neighbour pack, each hop's scoring is ``ops/hop.py``: on the card the
hand-written kernels ``hop_score`` (bf16 pack) and ``hop_score_int8`` (int8
codes). Scores inside the loop use the bf16 shadow; the final top-k is
re-scored in f32, so reported distances are exact.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.distance import BIG, _dist_bc
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric

_LATER = "waits for ops/sort.py, which a later slice of the port brings"


def _beam_merge(beam_d, beam_i, beam_e, cand_d, cand_i, ef: int,
                force: str | None = None):
    """Top-ef merge of [beam ++ candidates] carrying (id, expanded) payload.
    Candidates are fresh (never expanded); the beam is ascending.

    Default: one stable sort of the keys carrying the (id << 1) | expanded
    payload (as the reference's one-key ``lax.sort``); -1 ids map to -2/-1
    payloads whose arithmetic >> 1 restores -1. Variants behind force=:
    "topk" (stable top-k + payload gathers), "onehot" (top-k + one-hot
    payload reduction)."""
    if force in ("approx", "bitonic"):
        raise NotImplementedError(f"merge={force!r} {_LATER}")
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    all_i = torch.cat([beam_i, cand_i], dim=-1)
    all_e = torch.cat([beam_e, torch.zeros_like(cand_d, dtype=torch.bool)],
                      dim=-1)
    if force is None or force == "sort":
        pay = (all_i << 1) | all_e.to(all_i.dtype)
        kd, order = torch.sort(all_d, dim=-1, stable=True)
        kp = torch.gather(pay, -1, order[..., :ef])
        return kd[..., :ef], kp >> 1, (kp & 1) == 1
    kd, sel = top_k_ascending(all_d, ef)
    if force == "onehot":
        width = all_d.shape[-1]
        oh = sel[:, :, None] == torch.arange(width, device=sel.device)[None, None]
        ki = torch.amax(torch.where(oh, all_i[:, None, :], -(2 ** 31 - 1)),
                        dim=-1)
        ke = torch.any(oh & all_e[:, None, :], dim=-1)
        return kd, ki, ke
    return kd, torch.gather(all_i, -1, sel), torch.gather(all_e, -1, sel)


def _score(queries, rows, vectors, v_sq, metric, valid):
    """Gather+dot candidate scoring. With a bf16 shadow as `vectors`, the
    query is rounded to bf16 too and the products are f32 (exact), as the
    reference's bf16 einsum with an f32 result."""
    cand = vectors[rows]                                    # [B, C, D]
    qc = queries.to(cand.dtype).float()
    dots = torch.einsum("bd,bcd->bc", qc, cand.float())
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    c_sq = v_sq[rows]
    d = _dist_bc(dots, q_sq, c_sq, metric)
    return torch.where(valid, d, BIG)


def _greedy_descent(queries, cur, cur_d, adj_l, vectors, v_sq, metric):
    """One-probe greedy walk on an upper layer until no neighbour improves."""
    improving = torch.ones_like(cur, dtype=torch.bool)
    while bool(improving.any()):
        nb = adj_l[cur]                                     # [B, M]
        valid = (nb >= 0) & improving[:, None]
        d = _score(queries, torch.clamp(nb, min=0), vectors, v_sq, metric,
                   valid)
        j = torch.argmin(d, dim=-1, keepdim=True)           # first minimum
        best_d = torch.gather(d, -1, j)[:, 0]
        best_id = torch.gather(nb, -1, j)[:, 0]
        better = (best_d < cur_d) & improving
        cur = torch.where(better, best_id, cur)
        cur_d = torch.where(better, best_d, cur_d)
        improving = better
    return cur, cur_d


def _dedupe_row(ids, valid):
    """Within-row dedupe: mark later duplicates invalid. ids: [B, C]."""
    eq = ids[:, :, None] == ids[:, None, :]                 # [B, j, i]
    c = ids.shape[-1]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    dup = torch.any(eq & earlier & valid[:, None, :], dim=-1)
    return valid & ~dup


def hnsw_search_batch(
    vectors,                  # [N_pad, D] f32
    v_sq,                     # [N_pad]
    adj0,                     # int32 [N_pad, M0]
    adj_upper,                # int32 [L, N_pad, M] (L may be 0)
    entries,                  # int32 [B] per-query entry (or scalar), or
                              # [B, P] multi-entry seeds
    queries,                  # [B, D]
    *,
    k: int,
    ef: int,
    expand: int = 4,
    max_hops: int = 0,        # 0 => auto bound
    metric: Metric = Metric.COSINE,
    precision: str = "default",
    vectors_lp=None,          # bf16 shadow for in-loop scoring
    nbr_pack=None,            # [N_pad, M0, D] packed neighbour vectors (bf16)
                              # or int8 codes when nbr_scale is given
    nbr_sq=None,              # [N_pad, M0] their squared norms
    nbr_scale=None,           # [N_pad, M0] int8 dequant scales (marks the
                              # pack as int8 codes)
    debug_hops: bool = False,  # also return the hop count taken
    merge: str | None = None,  # beam-merge variant (see _beam_merge)
    queries_lp=None,         # [B, D_lp] projected queries for a reduced-dim
                              # shadow (vectors_lp / nbr_pack)
    v_sq_lp=None,             # [N_pad] squared norms of the reduced shadow
    rerank: int = 0,          # beam prefix the exact final re-rank
                              # considers (0 => k)
):
    """Full hierarchy search. Returns (dists [B, k], rows int32 [B, k]),
    rows = -1 for missing; with debug_hops also the number of hops taken."""
    from hnsw_tpu_torch.ops.hop import hop_score, hop_score_int8

    metric = Metric.coerce(metric)
    dev = vectors.device
    b = queries.shape[0]
    ef = max(ef, k)
    e = min(expand, ef)
    entries = torch.as_tensor(entries, dtype=torch.int32, device=dev)
    multi_entry = entries.ndim == 2
    if max_hops <= 0:
        # a serial search expands ~ef candidates; with e per hop that is
        # ef/e hops plus slack for stragglers; multi-entry beams interleave
        # P frontiers and need about twice the expansions
        max_hops = (2 * (ef // e) + 16) if multi_entry else (ef // e + 12)
    loop_vecs = vectors_lp if (vectors_lp is not None
                               and precision != "highest") else vectors
    q_loop = queries_lp if (queries_lp is not None
                            and precision != "highest") else queries
    v_sq_loop = v_sq_lp if (v_sq_lp is not None
                            and precision != "highest") else v_sq

    # ---- seed the beam -------------------------------------------------
    m0 = adj0.shape[1]
    c = e * m0
    beam_d = torch.full((b, ef), BIG, dtype=torch.float32, device=dev)
    beam_ids = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    if multi_entry:
        seeds = entries[:, :ef]                             # [B, P]
        d_seed = _score(q_loop, torch.clamp(seeds, min=0), loop_vecs,
                        v_sq_loop, metric, seeds >= 0)
        kd, order = torch.sort(d_seed, dim=-1, stable=True)
        kp = torch.gather(seeds, -1, order)
        # duplicate seeds score equal distances, so they land adjacent
        dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                         kp[:, 1:] == kp[:, :-1]], dim=1)
        kd = torch.where(dup, BIG, kd)
        p_seed = seeds.shape[1]
        beam_d[:, :p_seed] = kd
        beam_ids[:, :p_seed] = torch.where(kd < BIG, kp, -1)
    else:
        # ---- upper layers: greedy 1-probe descent ----------------------
        cur = torch.broadcast_to(entries, (b,)).clone()
        d0 = _score(q_loop, torch.clamp(cur[:, None], min=0), loop_vecs,
                    v_sq_loop, metric, (cur >= 0)[:, None])[:, 0]
        for l in range(adj_upper.shape[0] - 1, -1, -1):
            cur, d0 = _greedy_descent(q_loop, cur, d0, adj_upper[l],
                                      loop_vecs, v_sq_loop, metric)
        beam_d[:, 0] = d0
        beam_ids[:, 0] = cur
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    e_iota = torch.arange(e, dtype=torch.int32, device=dev)
    q_sq_loop = torch.sum(q_loop.float() ** 2, dim=-1, keepdim=True)
    q_kernel = q_loop.float().contiguous()

    active = torch.ones((b,), dtype=torch.bool, device=dev)
    hops = 0
    while hops < max_hops and bool(active.any()):
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
        onehot = take[:, None, :] & (pos[:, None, :] == e_iota[None, :, None])
        sel_ids = torch.amax(torch.where(onehot, beam_ids[:, None, :], -1),
                             dim=-1)                        # [B, E]

        sel_rows = torch.clamp(sel_ids, min=0)
        nb = adj0[sel_rows]                                 # [B, E, M0]
        nb = torch.where((sel_ids >= 0)[:, :, None], nb, -1).reshape(b, c)
        valid = _dedupe_row(nb, nb >= 0)
        # drop candidates already in the beam (every node that is or ever
        # was competitive — evicted nodes cannot return)
        in_beam = torch.any(nb[:, :, None] == beam_ids[:, None, :], dim=-1)
        valid = valid & ~in_beam

        if nbr_pack is not None:
            # bf16 packs get csq from the gathered block itself; int8 packs
            # return raw code dots, dequantized with the per-row scale
            if nbr_scale is not None:
                dots = hop_score_int8(nbr_pack, q_kernel, sel_rows)
                dots = dots * nbr_scale[sel_rows].reshape(b, c)
                c_sq = nbr_sq[sel_rows].reshape(b, c)
            else:
                dots, c_sq = hop_score(nbr_pack, q_kernel, sel_rows)
            d_nb = torch.where(valid, _dist_bc(dots, q_sq_loop, c_sq, metric),
                               BIG)
        else:
            d_nb = _score(q_loop, torch.clamp(nb, min=0), loop_vecs,
                          v_sq_loop, metric, valid)
        beam_d, beam_ids, beam_exp = _beam_merge(
            beam_d, beam_ids, beam_exp, d_nb, torch.where(valid, nb, -1), ef,
            force=merge)
        hops += 1

    # exact final re-rank of a `rerank`-wide beam prefix (wider for a
    # reduced-dim shadow, whose in-loop order is noisier)
    rw = min(max(rerank, k), ef)
    out_d = beam_d[:, :rw]
    out_i = torch.where(out_d < BIG, beam_ids[:, :rw], -1)
    if precision != "highest":
        out_d = _score(queries, torch.clamp(out_i, min=0), vectors, v_sq,
                       metric, out_i >= 0)
        out_d, sel = top_k_ascending(out_d, k)
        out_i = torch.gather(out_i, -1, sel)
        out_i = torch.where(out_d < BIG, out_i, -1)
    else:
        out_d, out_i = out_d[:, :k], out_i[:, :k]
    if debug_hops:
        return out_d, out_i, hops
    return out_d, out_i


def pack_neighbors(vectors_lp, v_sq, adj0):
    """Neighbourhood-contiguous block table for the hop loop:
    nbr_pack[i, j] = vectors_lp[adj0[i, j]] and nbr_sq[i, j] = v_sq of the
    same row (empty slots -> row 0; the search masks them by adj0 < 0)."""
    rows = torch.clamp(adj0, min=0)
    return vectors_lp[rows].contiguous(), v_sq[rows].contiguous()


def pack_neighbors_int8(vectors, v_sq, adj0):
    """int8 twin of pack_neighbors: per-row symmetric quantization of the
    (possibly reduced-dim) loop vectors, then the same pack. Returns (codes
    int8 [N_pad, M0, D], scales f32 [N_pad, M0], sq norms f32 [N_pad, M0]);
    the sq norms are the exact shadow norms."""
    vf = vectors.float()
    vmax = torch.amax(torch.abs(vf), dim=1, keepdim=True)
    scale = torch.clamp(vmax / 127.0, min=1e-12)
    v8 = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
    rows = torch.clamp(adj0, min=0)
    return (v8[rows].contiguous(), scale[:, 0][rows].contiguous(),
            v_sq[rows].contiguous())


def prepare_hop_fast_path(owner, corpus, adj0, *, expand: int,
                          pack_bytes_cap: int):
    """Shared wiring of the packed-neighbourhood bf16 hop path for the
    families that run hnsw_search_batch over disjoint subgraphs of one
    global adjacency (IVF-HNSW, partitioned HNSW). Caches the bf16 corpus
    shadow and the neighbour pack on `owner` (attributes _vec_lp, _nbr_pack,
    _nbr_sq) and returns the keyword arguments for hnsw_search_batch.

    Policy: bf16 loop scoring only for cosine (the euclidean norm formula
    cancels at bf16), and the pack only while its degree-duplicated bytes
    fit pack_bytes_cap. A used pack is scored by ops/hop.py (the CUDA
    kernel on the card), which takes every hop width: the reference's `ef`
    argument fed only its kernel's eligibility test and is not taken."""
    precision = "default" if corpus.metric == Metric.COSINE else "highest"
    if owner._vec_lp is None or owner._vec_lp.shape != corpus.vectors.shape:
        owner._vec_lp = corpus.vectors.to(torch.bfloat16)
        owner._nbr_pack = None
        owner._nbr_sq = None
    m0 = adj0.shape[1]
    dim = corpus.vectors.shape[1]
    use_pack = precision != "highest" and (
        adj0.shape[0] * m0 * (dim * 2 + 4) <= pack_bytes_cap)
    if use_pack and owner._nbr_pack is None:
        owner._nbr_pack, owner._nbr_sq = pack_neighbors(
            owner._vec_lp, corpus.sq_norms, adj0)
    return dict(precision=precision, vectors_lp=owner._vec_lp,
                nbr_pack=owner._nbr_pack if use_pack else None,
                nbr_sq=owner._nbr_sq if use_pack else None, expand=expand)


def sample_entries_grouped(vectors, v_sq, sample_rows, queries, *,
                           metric: Metric, r: int = 1):
    """Per-group top-r entry rows: one [B, P*S] f32 product, then a stable
    sort within each group's block. sample_rows: int32 [P, S] per-group
    candidate rows (-1 padded). Seeds each disjoint subgraph's part of a
    shared beam near the query. Returns entries [B, P*r] (global rows, -1
    padded)."""
    p, s = sample_rows.shape
    flat = sample_rows.reshape(-1)
    rows = torch.clamp(flat, min=0).long()
    sub = vectors[rows]                                     # [P*S, D]
    sub_sq = v_sq[rows]
    dots = torch.matmul(queries, sub.T)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    d = _dist_bc(dots, q_sq, sub_sq[None, :], Metric.coerce(metric))
    b = d.shape[0]
    d = torch.where((flat >= 0)[None, :], d, BIG).reshape(b, p, s)
    sd, order = torch.sort(d, dim=-1, stable=True)          # along S
    si = torch.gather(sample_rows[None].expand(b, p, s), -1, order)
    rr = min(r, s)
    out = torch.where(sd[:, :, :rr] < BIG, si[:, :, :rr], -1)
    return out.reshape(b, p * rr)


def sample_entries(vectors, v_sq, sample_rows, queries, *, metric: Metric):
    """Batched entry selection without hierarchy descent: score each query
    against a fixed row sample in one f32 product and seed the beam at the
    best. Returns (entries [B], d [B])."""
    sub = vectors[sample_rows]                              # [S, D]
    sub_sq = v_sq[sample_rows]
    dots = torch.matmul(queries, sub.T)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    d = _dist_bc(dots, q_sq, sub_sq[None, :], Metric.coerce(metric))
    j = torch.argmin(d, dim=-1, keepdim=True)
    return sample_rows[j[:, 0]], torch.gather(d, -1, j)[:, 0]

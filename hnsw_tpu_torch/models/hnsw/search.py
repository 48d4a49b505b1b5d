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

The reference jits the whole search, its hop loop and greedy descent
``lax.while_loop``s, so a batch runs from seeding to result with no host
round trip. On the card the port does too: the greedy descent is one launch
of the hand-written kernel ``ops/descent.py`` (``csrc/descent.cu``), and the
hop loop runs exactly ``max_hops`` bodies (``_hops_fixed``), so nothing
waits on the host and the whole search can be captured in one CUDA graph
(``HNSWIndex.search_batch`` replays one). On the CPU both keep their early
exit, a host check of ``any(active)`` per step.

With a neighbour pack, each hop's scoring is ``ops/hop.py``: on the card the
hand-written kernels ``hop_score`` (bf16 pack) and ``hop_score_int8`` (int8
codes). Scores inside the loop use the bf16 shadow; the final top-k is
re-scored in f32, so reported distances are exact. Every score that reads
rows (the hop without a pack, the seeds, the first entry, the re-rank) is
``ops/gather.py``: on the card one launch of its kernel, which reads only
the valid slots' rows.

A body's select reads only the beam that the previous body's merge left,
so the default merge and the next body's select are one step,
``ops/merge.py`` (on the card one launch of its kernel): the loop's state
carries the selected rows, and one such step with no candidates makes the
first body's select before the loop. A body is then expand, score, and
merge with the next select.

With device tracing on (``utils/tracing.py``) the search marks its phases,
``entry`` (the descent or the sampled entry, and the seed), ``select`` (the
first body's, before the loop), per body ``expand`` (adjacency gather,
dedupe, in-beam test: on the card one launch of the kernel of
``ops/expand.py``), ``score``, on the int8 pack's route ``dequant`` (from
the return of ``hop_score_int8``: the scale and norm gathers, the product,
the distance and the mask; ``score`` then holds the clamp and the kernel
alone), and ``merge`` (the merge and the next body's select), then
``rerank``; the card's loop also counts its useful work in
``count`` phases of its own (``_count_hops``). Off, it launches what it did
without them.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops.descent import greedy_descent
from hnsw_tpu_torch.ops.distance import BIG, _dist_bc
from hnsw_tpu_torch.ops.distance import shadow_score as _score
from hnsw_tpu_torch.ops.merge import select_plain, sort_merge
from hnsw_tpu_torch.ops.sort import bitonic_topk_presorted
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric
from hnsw_tpu_torch.utils import tracing


def _beam_merge(beam_d, beam_i, beam_e, cand_d, cand_i, ef: int,
                force: str | None = None):
    """Top-ef merge of [beam ++ candidates] carrying (id, expanded) payload.
    Candidates are fresh (never expanded); the beam is ascending.

    Default: ``ops/merge.py:sort_merge``, one stable sort of the keys
    carrying the payload, which the search runs fused with the next body's
    select (``hop_merge``). Variants behind force=:
    "topk" (stable top-k + payload gathers), "onehot" (top-k + one-hot
    payload reduction), "bitonic" (the ops/sort.py network over the sorted
    beam and the unsorted candidates) and "approx". The reference's
    "approx" is ``lax.approx_min_k(recall_target=0.95)``, which XLA lowers to
    an exact top-k off the TPU; here it is the exact stable top-k, which
    meets that recall target."""
    if force == "bitonic":
        pay_beam = (beam_i << 1) | beam_e.to(beam_i.dtype)
        kd, kv = bitonic_topk_presorted(beam_d, pay_beam, cand_d, cand_i << 1,
                                        ef)
        return kd, kv >> 1, (kv & 1) == 1
    if force is None or force == "sort":
        return sort_merge(beam_d, beam_i, beam_e, cand_d, cand_i)
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    all_i = torch.cat([beam_i, cand_i], dim=-1)
    all_e = torch.cat([beam_e, torch.zeros_like(cand_d, dtype=torch.bool)],
                      dim=-1)
    kd, sel = top_k_ascending(all_d, ef)
    if force == "onehot":
        width = all_d.shape[-1]
        oh = sel[:, :, None] == torch.arange(width, device=sel.device)[None, None]
        ki = torch.amax(torch.where(oh, all_i[:, None, :], -(2 ** 31 - 1)),
                        dim=-1)
        ke = torch.any(oh & all_e[:, None, :], dim=-1)
        return kd, ki, ke
    return kd, torch.gather(all_i, -1, sel), torch.gather(all_e, -1, sel)


def _runs_fixed_length(device) -> bool:
    """Whether the hop loop runs all max_hops bodies (the card: no host
    sync) rather than stopping once no query is active (the CPU)."""
    return device.type == "cuda"


def _hops_fixed(body, state, max_hops: int, count: bool):
    """The card's hop loop: exactly max_hops bodies, with no host sync.

    A body run after a query's `active` fell is a no-op for that query in
    the reference's own state: `take` is all false, so its sel_ids are -1,
    every candidate is invalid (BIG, -1), and the stable merge keeps the
    beam's (d, id, expanded) slots as they were. So rows and distances are
    those of the early-exit loop. `active` only ever falls, so adding
    any(active) before each body (state[4]: the pending body's `active`
    before its stop rule) counts the bodies the early-exit loop runs, the
    reference's trip count (a device scalar; None unless `count` or device
    tracing is on, whose counter hop.bodies_needed it feeds)."""
    hops = (torch.zeros((), dtype=torch.int32, device=state[0].device)
            if count or tracing.device_tracing() else None)
    for _ in range(max_hops):
        if hops is not None:
            hops += state[4].any()
        state = body(*state)
    return state, hops


def _count_hops(hops, max_hops: int, slots: int, active, valid,
                expanded: int, scored: int, merged: int, narrow: int, dev):
    """The card's loop's useful work, into the tracer's counters: the bodies
    run, those needed (the trip count `hops`), each body's queries still
    active after its stop rule (`active`, a device scalar a body), the
    slots scored (`slots` a body: B x E x M0), those left valid after the
    dedupe and the in-beam test (`valid`, a device scalar a body), the
    bodies whose expand launched the kernel of ops/expand.py (`expanded`),
    those whose score launched the kernel of ops/gather.py (`scored`: the
    bodies with no pack), those whose merge and next select launched the
    kernel of ops/merge.py (`merged`) and those whose int8 hop score took the
    narrow plan of ops/hop.py's kernel (`narrow`), each its launches counted
    while the loop ran."""
    tracing.count("hop.bodies_run", max_hops, dev)
    tracing.count("hop.bodies_needed", hops)
    tracing.count("hop.query_bodies_active", torch.stack(active).sum())
    tracing.count("hop.slots_scored", max_hops * slots, dev)
    tracing.count("hop.slots_valid", torch.stack(valid).sum())
    tracing.count("hop.expand_kernel_bodies", expanded, dev)
    tracing.count("hop.score_kernel_bodies", scored, dev)
    tracing.count("hop.merge_kernel_bodies", merged, dev)
    tracing.count("hop.score_int8_narrow_bodies", narrow, dev)


def hnsw_search_batch(*args, debug_hops: bool = False, **kwargs):
    """Full hierarchy search (arguments: _search_batch). Returns (dists
    [B, k], rows int32 [B, k]), rows = -1 for missing; with debug_hops also
    the number of hops taken, read from the card once, after the result."""
    out_d, out_i, hops = _search_batch(*args, debug_hops=debug_hops,
                                       **kwargs)
    return (out_d, out_i, int(hops)) if debug_hops else (out_d, out_i)


def _search_batch(
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
    debug_hops: bool = False,  # count the hops taken
    merge: str | None = None,  # beam-merge variant (see _beam_merge)
    queries_lp=None,         # [B, D_lp] projected queries for a reduced-dim
                              # shadow (vectors_lp / nbr_pack)
    v_sq_lp=None,             # [N_pad] squared norms of the reduced shadow
    rerank: int = 0,          # beam prefix the exact final re-rank
                              # considers (0 => k)
):
    """hnsw_search_batch with no host sync on the card. Returns (dists
    [B, k], rows int32 [B, k], hops): rows = -1 for missing; hops is the
    hop count, an int on the CPU and a device scalar on the card (None there
    unless debug_hops), which a captured graph returns without a sync."""
    from hnsw_tpu_torch.ops.expand import hop_expand
    from hnsw_tpu_torch.ops.gather import hop_gather_score
    from hnsw_tpu_torch.ops.hop import hop_score, hop_score_int8
    from hnsw_tpu_torch.ops.merge import hop_merge

    metric = Metric.coerce(metric)
    dev = vectors.device
    tracing.mark("entry", dev)
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

    q_sq_loop = torch.sum(q_loop.float() ** 2, dim=-1, keepdim=True)

    # ---- seed the beam -------------------------------------------------
    m0 = adj0.shape[1]
    c = e * m0
    beam_d = torch.full((b, ef), BIG, dtype=torch.float32, device=dev)
    beam_ids = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    if multi_entry:
        seeds = entries[:, :ef]                             # [B, P]
        d_seed = _score(q_loop, torch.clamp(seeds, min=0), loop_vecs,
                        v_sq_loop, metric, seeds >= 0, q_sq_loop)
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
                    v_sq_loop, metric, (cur >= 0)[:, None], q_sq_loop)[:, 0]
        # every upper layer in one walk: the kernel of ops/descent.py on a
        # CUDA tensor, its plain batch loop on the CPU
        cur, d0 = greedy_descent(q_loop, q_sq_loop, cur, d0, adj_upper,
                                 loop_vecs, v_sq_loop, metric)
        beam_d[:, 0] = d0
        beam_ids[:, 0] = cur
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    q_kernel = q_loop.float().contiguous()

    fixed = _runs_fixed_length(dev)
    # with device tracing on, the card's loop counts each body's active
    # queries and valid slots, in `count` phases of its own
    tally = ([], []) if fixed and tracing.device_tracing() else None

    def update(beam_d, beam_ids, beam_exp, d_nb, cand, active):
        """The merge of a body's scored candidates (none before the loop)
        and the next body's select: the kernel of ops/merge.py on a CUDA
        tensor (one launch), its plain operators on the CPU; a merge
        variant, then the plain select."""
        if merge is None or merge == "sort":
            if d_nb is None:
                d_nb = torch.empty((b, 0), dtype=beam_d.dtype, device=dev)
                cand = torch.empty((b, 0), dtype=torch.int32, device=dev)
            return hop_merge(beam_d, beam_ids, beam_exp, d_nb, cand, active,
                             e)
        if d_nb is not None:
            beam_d, beam_ids, beam_exp = _beam_merge(
                beam_d, beam_ids, beam_exp, d_nb, cand, ef, force=merge)
        return select_plain(beam_d, beam_ids, beam_exp, active, e)

    def body(beam_d, beam_ids, beam_exp, sel_ids, _, active):
        # sel_ids: this body's rows, selected where `active` (after this
        # body's stop rule) holds
        tracing.mark("expand", dev)
        # the kernel of ops/expand.py on a CUDA tensor (one launch), its
        # plain operators on the CPU: the E rows' neighbours in slot order,
        # -1 and not valid where unselected, a later duplicate or in the
        # beam (every node that is or ever was competitive: evicted nodes
        # cannot return)
        cand, valid = hop_expand(adj0, sel_ids, beam_ids)   # [B, E*M0]

        tracing.mark("score", dev)
        if nbr_pack is not None:
            # bf16 packs get csq from the gathered block itself; int8 packs
            # return raw code dots, dequantized with the per-row scale;
            # hop_score reads row 0 for an unselected (-1) row
            if nbr_scale is not None:
                sel_rows = torch.clamp(sel_ids, min=0)
                dots = hop_score_int8(nbr_pack, q_kernel, sel_rows)
                # the scales and norms, the distance and the mask
                tracing.mark("dequant", dev)
                dots = dots * nbr_scale[sel_rows].reshape(b, c)
                c_sq = nbr_sq[sel_rows].reshape(b, c)
            else:
                dots, c_sq = hop_score(nbr_pack, q_kernel, sel_ids)
            d_nb = torch.where(valid, _dist_bc(dots, q_sq_loop, c_sq, metric),
                               BIG)
        else:
            # the kernel of ops/gather.py on a CUDA tensor (one launch,
            # reading only the valid slots' rows), its plain operators on
            # the CPU
            d_nb = _score(q_loop, torch.clamp(cand, min=0), loop_vecs,
                          v_sq_loop, metric, valid, q_sq_loop)
        tracing.mark("merge", dev)
        beam_d, beam_ids, beam_exp, sel_next, active_next = update(
            beam_d, beam_ids, beam_exp, d_nb, cand, active)
        if tally is not None:
            tracing.mark("count", dev)
            tally[0].append(active.sum())
            tally[1].append(valid.sum())
        # the next body's state: its `active` before and after its stop rule
        return beam_d, beam_ids, beam_exp, sel_next, active, active_next

    # the first body's select (with the default merge, one launch of the
    # kernel of ops/merge.py with no candidates, which also sorts the seeds)
    tracing.mark("select", dev)
    ones = torch.ones((b,), dtype=torch.bool, device=dev)
    beam_d, beam_ids, beam_exp, sel_ids, active = update(
        beam_d, beam_ids, beam_exp, None, None, ones)
    state = (beam_d, beam_ids, beam_exp, sel_ids, ones, active)
    if fixed:
        if tally is not None:
            tracing.mark("count", dev)
            launched = (hop_expand.launches, hop_gather_score.launches,
                        hop_merge.launches, hop_score_int8.narrow_launches)
        state, hops = _hops_fixed(body, state, max_hops, debug_hops)
        if tally is not None:
            _count_hops(hops, max_hops, b * c, *tally,
                        hop_expand.launches - launched[0],
                        hop_gather_score.launches - launched[1],
                        hop_merge.launches - launched[2],
                        hop_score_int8.narrow_launches - launched[3], dev)
    else:
        hops = 0
        while hops < max_hops and bool(state[4].any()):
            state = body(*state)
            hops += 1
    tracing.mark("rerank", dev)
    beam_d, beam_ids = state[0], state[1]

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
    tracing.mark(tracing.END, dev)
    return out_d, out_i, hops


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
    """hnsw_search_batch's keywords for IVF-HNSW and partitioned HNSW from
    their shadow.HopShadow `owner`: a bf16 pack while it fits
    pack_bytes_cap, else none (never int8). No `ef`: the reference's fed
    only its Pallas kernel's eligibility test."""
    return dict(owner.prepare(corpus, adj0, pack_precision="bf16",
                              cap=pack_bytes_cap).kwargs, expand=expand)


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

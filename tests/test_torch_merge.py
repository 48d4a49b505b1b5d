"""The beam update of the hop body (hnsw_tpu_torch/ops/merge.py) on the CPU:
the plain version against a loop written out on the kernel's contract, a
model of csrc/merge.cu's plan (order keys, ranks, binary searches, the
chunked ballot prefix) against the same loop, the wrapper's CPU route and
refusals, the search's loop with the select carried one body early against
the loop in the old order (select, expand, score, merge), and the counter of
bodies whose update ran the kernel. No JAX; the kernel itself runs in
tests/test_torch_gpu.py on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import build_hnsw_index
from hnsw_tpu_torch.models import hnsw as hnsw_models
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.ops import expand, merge
from hnsw_tpu_torch.ops.distance import BIG, shadow_score
from hnsw_tpu_torch.utils import tracing

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "hnsw_tpu_torch"
          / "csrc" / "merge.cu").read_text()
BIG32 = np.float32(BIG)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def contract(beam_d, beam_ids, beam_exp, cand_d, cand_ids, active, e):
    """The kernel's contract as a loop over queries: a stable sort of the
    beam then the candidates by distance (Python's sort is stable, and
    -0.0 == 0.0), its first ef entries, then the select on them."""
    b_n, ef = beam_d.shape
    out_d = np.empty_like(beam_d)
    out_i = np.empty_like(beam_ids)
    out_e = np.empty_like(beam_exp)
    sel = np.full((b_n, e), -1, np.int32)
    act = np.zeros(b_n, bool)
    for b in range(b_n):
        entries = [(beam_d[b, t], beam_ids[b, t], bool(beam_exp[b, t]))
                   for t in range(ef)]
        entries += [(cand_d[b, j], cand_ids[b, j], False)
                    for j in range(cand_d.shape[1])]
        kept = sorted(entries, key=lambda x: float(x[0]))[:ef]
        d = np.array([x[0] for x in kept], np.float32)
        ids = np.array([x[1] for x in kept], np.int32)
        exp = np.array([x[2] for x in kept], bool)
        elig = ~exp & (ids >= 0)
        sel_d0 = min(float(d[t]) if elig[t] else float(BIG32)
                     for t in range(ef))
        go = bool(active[b]) and sel_d0 < BIG32 and sel_d0 <= d[-1]
        taken = np.flatnonzero(elig)[:e] if go else []
        for r, t in enumerate(taken):
            sel[b, r] = ids[t]
            exp[t] = True
        out_d[b], out_i[b], out_e[b], act[b] = d, ids, exp, go
    return out_d, out_i, out_e, sel, act


def inputs(b, ef, c, e, kind, seed):
    """A beam ascending by distance (its live prefix, then BIG / -1 slots),
    about half its live slots expanded, candidates (a third invalid: BIG /
    -1) and active flags (a tenth false). Distances come from a few values,
    so that candidates tie with each other and with the beam. kind: "ties"
    (three values), "signed_zero" (-0.0, 0.0 and 0.25), "all_big" (every
    candidate invalid), "holes" (BIG / -1 slots between the beam's live
    ones, as multi-entry seeds leave them), "few_eligible" (fewer than e
    unexpanded live slots, and every candidate invalid), "inactive" (every
    query stopped), "stop_edge" (a full beam of one distance with only its
    last slot unexpanded, so the best unexpanded equals the worst)."""
    rng = np.random.default_rng(seed)
    values = {"ties": [0.1, 0.2, 0.3],
              "signed_zero": [-0.0, 0.0, 0.25]}.get(
        kind, np.linspace(-1.0, 1.0, 24))
    values = np.asarray(values, np.float32)
    live = rng.integers(0, ef + 1, size=b)
    live[0] = ef                                   # a full beam
    beam_d = np.full((b, ef), BIG32, np.float32)
    beam_ids = np.full((b, ef), -1, np.int32)
    beam_exp = np.zeros((b, ef), bool)
    for q in range(b):
        f = live[q]
        beam_d[q, :f] = np.sort(rng.choice(values, f), kind="stable")
        beam_ids[q, :f] = rng.integers(0, 1 << 20, f)
        beam_exp[q, :f] = rng.random(f) < 0.5
    cand_d = rng.choice(values, (b, c)).astype(np.float32)
    cand_ids = rng.integers(0, 1 << 20, (b, c)).astype(np.int32)
    invalid = rng.random((b, c)) < 0.3
    if kind in ("all_big", "few_eligible"):
        invalid[:] = True
    cand_d[invalid] = BIG32
    cand_ids[invalid] = -1
    active = rng.random(b) >= 0.1
    if kind == "inactive":
        active[:] = False
    elif kind == "holes":
        hole = (rng.random((b, ef)) < 0.3) & (beam_d < BIG32)
        beam_d[hole], beam_ids[hole], beam_exp[hole] = BIG32, -1, False
    elif kind == "few_eligible":
        beam_exp[beam_ids >= 0] = True
        for q in range(b):
            live_slots = np.flatnonzero(beam_ids[q] >= 0)
            free = rng.permutation(live_slots)[:rng.integers(0, e)]
            beam_exp[q, free] = False
    elif kind == "stop_edge":
        beam_d[:] = values[5]
        beam_ids[:] = rng.integers(0, 1 << 20, (b, ef))
        beam_exp[:] = True
        beam_exp[:, -1] = False
        cand_d[:] = BIG32
        cand_ids[:] = -1
        active[:] = True
    return beam_d, beam_ids, beam_exp, cand_d, cand_ids, active


# (kind, B, ef, C, E): the cells' body (ef 200, C = E x M0 = 128) at B = 1
# and 64; ties; -0.0 against 0.0; every candidate invalid; no candidates
# (the select before the loop), on a sorted beam and on one with
# multi-entry holes; holes with candidates; ragged widths (C = 21, ef =
# 203: not multiples of four or 32); a wide hop (C = 512, past ef); fewer
# than E eligible slots; every query stopped; best unexpanded == worst
CASES = [("mixed", 1, 200, 128, 4), ("mixed", 64, 200, 128, 4),
         ("ties", 32, 200, 128, 4), ("signed_zero", 32, 64, 32, 4),
         ("all_big", 16, 200, 128, 4), ("mixed", 16, 200, 0, 4),
         ("holes", 16, 200, 0, 4), ("holes", 16, 200, 128, 4),
         ("mixed", 16, 203, 21, 3), ("mixed", 8, 200, 512, 4),
         ("few_eligible", 16, 50, 21, 8), ("inactive", 8, 200, 128, 4),
         ("stop_edge", 8, 40, 16, 4)]


def _same(got, want):
    """Bit for bit: distances compared as their bits (so -0.0 != 0.0)."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,b,ef,c,e", CASES)
def test_plain_version_is_the_contract(kind, b, ef, c, e):
    arrays = inputs(b, ef, c, e, kind, seed=b * 1000 + ef + c)
    want = contract(*arrays, e)
    got = merge.hop_merge_plain(*(torch.from_numpy(a) for a in arrays), e)
    _same(got, want)
    sel, act = want[3], want[4]
    if kind in ("inactive",):
        assert not act.any() and (sel == -1).all()
    elif kind == "stop_edge":
        assert act.all() and (sel[:, 0] >= 0).all()
        assert (sel[:, 1:] == -1).all()
    else:
        assert act.any() and (sel >= 0).any()
    if kind == "few_eligible":
        assert ((sel >= 0).sum(1) < e).all()
    if kind == "signed_zero":
        assert (np.signbit(want[0]) & (want[0] == 0)).any()


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} is not where this test reads it"
    return int(m.group(1))


def order_keys(d):
    """merge.cu's order_key: unsigned order is float order, -0.0 == 0.0."""
    u = d.view(np.uint32).astype(np.int64)
    u = np.where(u == 0x80000000, 0, u)
    key = np.where(u & 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return np.where(np.isnan(d), 0xFFFFFFFF, key)


def count_below(keys, k, strict):
    """merge.cu's count_below: binary lifting over ascending keys."""
    n, pos = len(keys), 0
    step = 1 << (n.bit_length() - 1) if n else 0
    while step:
        nxt = pos + step
        if nxt <= n and (keys[nxt - 1] < k if strict else keys[nxt - 1] <= k):
            pos = nxt
        step >>= 1
    return pos


def kernel_model(beam_d, beam_ids, beam_exp, cand_d, cand_ids, active, e):
    """csrc/merge.cu's plan in numpy, query by query: a block of
    round_up(max(ef, C), 32) threads (at most kMaxThreads); each
    candidate's stable rank among the candidates by compares with the keys
    padded to a multiple of four, in three ranges a warp, and its key stored
    at that rank; the beam's ascending test; each entry's place from
    its rank and a binary search (ef compares a slot where the beam is not
    ascending); the first eligible slot; the ballot prefix chunk by chunk
    of the block's width, warp by warp."""
    max_threads = _source_int("kMaxThreads")
    big = np.float32(float(re.search(r"kBig = ([0-9e.]+)f;",
                                     SOURCE).group(1)))
    assert big == BIG32
    b_n, ef = beam_d.shape
    c = cand_d.shape[1]
    threads = min(-(-max(ef, c) // 32) * 32, max_threads)
    out = [np.empty_like(beam_d), np.empty_like(beam_ids),
           np.empty_like(beam_exp), np.full((b_n, e), -7, np.int32),
           np.zeros(b_n, bool)]
    for b in range(b_n):
        bk, ck = order_keys(beam_d[b]), order_keys(cand_d[b])
        # the keys padded to a multiple of four with the largest; a warp's
        # candidates j0 + lane count the keys before j0 where <= kj, those
        # from the warp's end where < kj, its own by both tests
        ck4 = np.concatenate([ck, np.full(-c % 4, 0xFFFFFFFF)])
        idx = np.arange(c)
        crank = np.full(c, -1, int)
        for warp0 in range(0, threads, 32):
            for j0 in range(warp0, c, threads):
                own = min(j0 + 32, len(ck4))
                for j in range(j0, min(j0 + 32, c)):
                    w = np.arange(j0, own)
                    crank[j] = int((ck4[:j0] <= ck[j]).sum()
                                   + ((ck4[j0:own] < ck[j])
                                      | ((ck4[j0:own] == ck[j]) & (w < j)))
                                   .sum()
                                   + (ck4[own:] < ck[j]).sum())
        cs = np.full(c, -1, np.int64)
        cs[crank] = ck
        assert (np.sort(crank) == idx).all()
        ascending = bool((bk[:-1] <= bk[1:]).all())
        od = np.full(ef, np.nan, np.float32)
        oid = np.zeros(ef, np.int32)
        oexp = np.zeros(ef, bool)
        written = np.zeros(ef, int)
        for j in range(c):
            if crank[j] >= ef:
                continue
            place = crank[j] + (count_below(bk, ck[j], False) if ascending
                                else int((bk <= ck[j]).sum()))
            if place < ef:
                od[place], oid[place], oexp[place] = cand_d[b, j], \
                    cand_ids[b, j], False
                written[place] += 1
        slots = np.arange(ef)
        for t in range(ef):
            place = t if ascending else int(
                ((bk < bk[t]) | ((bk == bk[t]) & (slots < t))).sum())
            place += count_below(cs, bk[t], True)
            if place < ef:
                od[place], oid[place], oexp[place] = beam_d[b, t], \
                    beam_ids[b, t], beam_exp[b, t]
                written[place] += 1
        assert (written == 1).all()       # every slot by one entry, once
        elig = ~oexp & (oid >= 0)
        first = int(np.flatnonzero(elig)[0]) if elig.any() else ef
        nan = bool(np.isnan(od[elig]).any())
        go = bool(active[b]) and not nan and first < ef \
            and od[first] < big and od[first] <= od[-1]
        seen = 0
        sel = np.full(e, -7, np.int32)
        for base in range(0, ef, threads):
            t = base + np.arange(threads)
            el = np.concatenate([elig, np.zeros(threads, bool)])[t]
            counts = el.reshape(-1, 32).sum(1)
            for lane_t in range(threads):
                warp, lane = divmod(lane_t, 32)
                r = seen + counts[:warp].sum() + el[warp * 32:lane_t].sum()
                if go and el[lane_t] and r < e:
                    sel[r] = oid[t[lane_t]]
                    oexp[t[lane_t]] = True
            seen += counts.sum()
        sel[(min(seen, e) if go else 0):] = -1
        assert (sel != -7).all()          # every row of sel written
        out[0][b], out[1][b], out[2][b], out[3][b], out[4][b] = \
            od, oid, oexp, sel, go
    return out


@pytest.mark.parametrize("kind,b,ef,c,e", CASES + [
    ("mixed", 3, 1500, 64, 4), ("holes", 3, 1100, 0, 4),
    ("mixed", 3, 64, 1100, 4)])
def test_kernel_plan_is_the_contract(kind, b, ef, c, e):
    """The plan at every case, and past kMaxThreads: a beam of 1,500 and of
    1,100 with holes (the prefix runs in two chunks), 1,100 candidates."""
    arrays = inputs(b, ef, c, e, kind, seed=b * 7 + ef + c)
    _same(kernel_model(*arrays, e), contract(*arrays, e))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    arrays = [torch.from_numpy(a) for a in inputs(16, 203, 21, 3, "mixed", 2)]
    before = merge.hop_merge.launches
    got = merge.hop_merge(*arrays, 3)
    want = merge.hop_merge_plain(*arrays, 3)
    assert merge.hop_merge.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_check_refuses_what_the_kernel_cannot_take():
    """CPU tensors, and a mix with another device, are refused before any
    pointer is passed (the card test adds dtypes, strides and widths)."""
    arrays = [torch.from_numpy(a) for a in inputs(4, 200, 128, 4, "mixed", 1)]
    with pytest.raises(ValueError):
        merge._check(*arrays, 4)
    with pytest.raises(ValueError):
        merge.hop_merge(*arrays[:5], arrays[5].to("meta"), 4)


@pytest.fixture(scope="module")
def small_index():
    data = generate_vectors(700, 32, distribution="embedding",
                            num_clusters=8, seed=3)
    return build_hnsw_index(data[:600], M=8, device="cpu"), data[600:632]


def old_order(index, q, entries, k, ef, e, max_hops):
    """The hop loop in the order before the select moved into the merge:
    a body selects, expands, scores and merges (f32 scoring, no upper
    layers). Returns the beam, the bodies needed and, per body, the queries
    active after its stop rule and the slots left valid."""
    vectors, v_sq = index.corpus.vectors, index.corpus.sq_norms
    metric = index.corpus.metric
    adj0 = index.graph.adj0
    b = q.shape[0]
    beam_d = torch.full((b, ef), BIG, dtype=torch.float32)
    beam_ids = torch.full((b, ef), -1, dtype=torch.int32)
    if entries.ndim == 2:
        d_seed = shadow_score(q, torch.clamp(entries, min=0), vectors, v_sq,
                              metric, entries >= 0)
        kd, order = torch.sort(d_seed, dim=-1, stable=True)
        kp = torch.gather(entries, -1, order)
        dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool),
                         kp[:, 1:] == kp[:, :-1]], dim=1)
        kd = torch.where(dup, BIG, kd)
        beam_d[:, :kd.shape[1]] = kd
        beam_ids[:, :kd.shape[1]] = torch.where(kd < BIG, kp, -1)
    else:
        beam_d[:, 0] = shadow_score(q, entries[:, None], vectors, v_sq,
                                    metric, (entries >= 0)[:, None])[:, 0]
        beam_ids[:, 0] = entries
    beam_exp = torch.zeros((b, ef), dtype=torch.bool)
    active = torch.ones((b,), dtype=torch.bool)
    needed, actives, valids = 0, [], []
    for _ in range(max_hops):
        needed += int(active.any())
        _, _, beam_exp, sel_ids, active = merge.select_plain(
            beam_d, beam_ids, beam_exp, active, e)
        cand, valid = expand.hop_expand_plain(adj0, sel_ids, beam_ids)
        d_nb = shadow_score(q, torch.clamp(cand, min=0), vectors, v_sq,
                            metric, valid)
        beam_d, beam_ids, beam_exp = merge.sort_merge(
            beam_d, beam_ids, beam_exp, d_nb, cand)
        actives.append(int(active.sum()))
        valids.append(int(valid.sum()))
    return beam_d, beam_ids, needed, actives, valids


@pytest.mark.parametrize("seeding", ["single", "multi"])
def test_carried_select_gives_the_old_order_bit_for_bit(seeding, small_index,
                                                        monkeypatch):
    """The card's fixed-length loop, forced on the CPU, with device tracing
    on: its rows, distances and counters (bodies needed, queries active
    after each body's stop rule, valid slots) are those of the loop in the
    old order, body for body; the early-exit loop gives the same rows,
    distances and hop count."""
    index, data = small_index
    q = index.corpus.pad_queries(data)
    b, k, ef, e = q.shape[0], 10, 40, 4
    rng = np.random.default_rng(11)
    if seeding == "multi":
        seeds = rng.integers(0, 600, (b, 5)).astype(np.int32)
        seeds[:, 4] = seeds[:, 0]                 # a duplicate seed
        seeds[::3, 2] = -1                        # a missing one
        entries = torch.from_numpy(seeds)
        max_hops = 2 * (ef // e) + 16
    else:
        entries = torch.from_numpy(rng.integers(0, 600, b).astype(np.int32))
        max_hops = ef // e + 12
    args = (index.corpus.vectors, index.corpus.sq_norms, index.graph.adj0,
            index.graph.adj_upper[:0], entries, q)
    kw = dict(k=k, ef=ef, expand=e, metric=index.corpus.metric,
              precision="highest", debug_hops=True)
    ed, er, ehops = hnsw_search.hnsw_search_batch(*args, **kw)
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    tracing.enable_device(False)
    tracing.collect()
    try:
        tracing.enable_device(True)
        fd, fr, fhops = hnsw_search.hnsw_search_batch(*args, **kw)
    finally:
        tracing.enable_device(False)
        got = tracing.collect()
    beam_d, beam_ids, needed, actives, valids = old_order(
        index, q, entries, k, ef, e, max_hops)
    want_r = torch.where(beam_d[:, :k] < BIG, beam_ids[:, :k], -1)
    assert torch.equal(fr, want_r) and torch.equal(fd, beam_d[:, :k])
    assert torch.equal(er, fr) and torch.equal(ed, fd)
    assert ehops == fhops == needed
    c = got.counters
    assert c["hop.bodies_run"] == max_hops
    assert c["hop.bodies_needed"] == needed
    assert c["hop.query_bodies_active"] == sum(actives)
    assert c["hop.slots_valid"] == sum(valids)
    assert 0 < sum(actives) < b * max_hops


@pytest.mark.parametrize("route", ["plain", "kernel", "variant"])
def test_counter_counts_the_bodies_that_launched_the_kernel(
        route, small_index, monkeypatch):
    """The card's fixed-length loop, forced on the CPU: with the plain
    version no body counts; with a stand-in kernel (the plain version that
    counts a launch) every body does, the launch before the loop not
    counted, and the rows are the same; a merge variant launches none."""
    index, q = small_index
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    calls = []
    if route == "kernel":
        def counting(*args):
            counting.launches += 1
            calls.append(args[3].shape[1])
            return merge.hop_merge_plain(*args)
        counting.launches = 0
        monkeypatch.setattr(merge, "hop_merge", counting)
    if route == "variant":
        real = hnsw_models._search_batch
        monkeypatch.setattr(hnsw_models, "_search_batch",
                            lambda *a, **kw: real(*a, merge="topk", **kw))
    tracing.enable_device(False)
    tracing.collect()
    d0, r0 = index.search_batch(q, 10, "balanced")
    try:
        tracing.enable_device(True)
        d1, r1 = index.search_batch(q, 10, "balanced")
    finally:
        tracing.enable_device(False)
        got = tracing.collect()
    assert torch.equal(r0, r1) and torch.equal(d0, d1)
    c = got.counters
    max_hops = 200 // 4 + 12
    assert c["hop.bodies_run"] == max_hops
    assert c["hop.merge_kernel_bodies"] == (max_hops if route == "kernel"
                                            else 0)
    if route == "kernel":
        # each search: one update with no candidates, then one a body
        assert calls == 2 * ([0] + [4 * index.graph.m0] * max_hops)

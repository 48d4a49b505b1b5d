"""The expand phase of the hop body (hnsw_tpu_torch/ops/expand.py) on the CPU:
the plain version against a loop written out on the kernel's contract, a
model of csrc/expand.cu's split of the slots over warps against the same
loop, the wrapper's CPU route and refusals, and the counter of bodies whose
expand ran the kernel. No JAX; the kernel itself runs in
tests/test_torch_gpu.py on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import build_hnsw_index
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.ops import expand
from hnsw_tpu_torch.utils import tracing

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "hnsw_tpu_torch"
          / "csrc" / "expand.cu").read_text()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def contract(adj0, sel, beam):
    """The kernel's contract as a loop over queries and slots."""
    b_n, e_n = sel.shape
    m0 = adj0.shape[1]
    c = e_n * m0
    cand = np.full((b_n, c), -1, np.int32)
    valid = np.zeros((b_n, c), bool)
    for b in range(b_n):
        held, in_beam = set(), set(beam[b].tolist())
        for s in range(c):
            e, m = divmod(s, m0)
            i = int(adj0[sel[b, e], m]) if sel[b, e] >= 0 else -1
            if i >= 0 and i not in held and i not in in_beam:
                cand[b, s], valid[b, s] = i, True
            if i >= 0:
                held.add(i)
    return cand, valid


def inputs(b, e, m0, ef, seed, kind="mixed"):
    """adj0 over few ids, so that rows repeat ids and share them (a tenth of
    the slots -1); sel_ids with repeated rows and -1 rows; a beam that holds
    up to half the ids, then -1 slots. kind "unselected": every sel_id
    -1; "all_in_beam": the beam holds every id of adj0."""
    rng = np.random.default_rng(seed)
    n = max(3 * m0, 40)
    adj0 = rng.integers(0, n, size=(n, m0), dtype=np.int32)
    adj0[rng.random((n, m0)) < 0.1] = -1
    sel = rng.integers(0, n, size=(b, e), dtype=np.int32)
    if e > 1:
        sel[::3, 1] = sel[::3, 0]                 # a row selected twice
    sel[rng.random((b, e)) < 0.15] = -1
    beam = np.full((b, ef), -1, np.int32)
    for q, f in enumerate(rng.integers(0, min(ef, n // 2) + 1, size=b)):
        beam[q, :f] = rng.permutation(n)[:f]
    if kind == "unselected":
        sel[:] = -1
    elif kind == "all_in_beam":
        ids = np.unique(adj0[adj0 >= 0])
        assert ids.size <= ef
        beam[:] = -1
        beam[:, :ids.size] = ids
    return adj0, sel, beam


# (B, E, M0, ef, kind): the cells' shape at B = 1 and 256, ragged widths
# (C = 21, ef not a multiple of four), a wide hop (C = 512), no row selected,
# every candidate already in the beam
CASES = [(1, 4, 32, 200, "mixed"), (37, 3, 7, 50, "mixed"),
         (256, 4, 32, 200, "mixed"), (64, 8, 64, 300, "mixed"),
         (16, 4, 32, 200, "unselected"), (16, 4, 8, 200, "all_in_beam")]


@pytest.mark.parametrize("b,e,m0,ef,kind", CASES)
def test_plain_version_is_the_contract(b, e, m0, ef, kind):
    adj0, sel, beam = inputs(b, e, m0, ef, seed=b * 1000 + m0, kind=kind)
    want_c, want_v = contract(adj0, sel, beam)
    got_c, got_v = expand.hop_expand_plain(
        torch.from_numpy(adj0), torch.from_numpy(sel), torch.from_numpy(beam))
    assert got_c.dtype == torch.int32 and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    if kind == "mixed":
        # the inputs hold what the contract drops: duplicates and ids in
        # the beam, besides kept ids
        ids = np.where(sel[:, :, None] >= 0, adj0[np.maximum(sel, 0)], -1)
        assert (ids.reshape(b, -1) >= 0).sum() > want_v.sum() > 0
    else:
        assert not want_v.any()


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} is not where this test reads it"
    return int(m.group(1))


def kernel_model(adj0, sel, beam):
    """csrc/expand.cu's plan in numpy: a block of round_up(C, 32) threads
    (at most kMaxThreads, stepping by the block over wider rows), each warp
    its 32 slots from s0, duplicates inside the warp by match_any (a lower
    lane with the id), those of earlier warps by a scan of the staged ids
    [0, s0) four at a time, the beam padded with -1 to a multiple of four."""
    max_threads = _source_int("kMaxThreads")
    b_n, e_n = sel.shape
    m0 = adj0.shape[1]
    c = e_n * m0
    threads = max_threads if c >= max_threads else -(-c // 32) * 32
    ef4 = -(-beam.shape[1] // 4) * 4
    cand = np.full((b_n, c), -1, np.int32)
    valid = np.zeros((b_n, c), bool)
    for b in range(b_n):
        s = np.arange(c)
        staged = np.where(sel[b, s // m0] >= 0,
                          adj0[np.maximum(sel[b, s // m0], 0), s % m0], -1)
        beam_s = np.full(ef4, -1, np.int32)
        beam_s[:beam.shape[1]] = beam[b]
        seen = np.zeros(c, int)
        for warp0 in range(0, threads, 32):
            for s0 in range(warp0, c, threads):
                lanes = np.arange(32)
                ids = np.where(s0 + lanes < c,
                               staged[np.minimum(s0 + lanes, c - 1)], -1)
                lower = (ids[:, None] == ids[None, :]) & \
                    (lanes[None, :] < lanes[:, None])
                ok = (ids >= 0) & ~lower.any(1)
                assert s0 % 4 == 0
                ok &= ~(ids[:, None] == staged[None, :s0]).any(1)
                ok &= ~(ids[:, None] == beam_s[None, :]).any(1)
                live = s0 + lanes < c
                seen[s0 + lanes[live]] += 1
                cand[b, s0 + lanes[live]] = np.where(ok, ids, -1)[live]
                valid[b, s0 + lanes[live]] = ok[live]
        assert (seen == 1).all()          # every slot by one lane, once
    return cand, valid


@pytest.mark.parametrize("e,m0,ef", [(4, 32, 200), (3, 7, 50), (1, 1, 7),
                                     (8, 64, 300), (5, 300, 13)])
def test_kernel_plan_is_the_contract(e, m0, ef):
    """The warp split at C = 128 (the cells), 21, 1, 512 and 1,500 (past
    kMaxThreads, so warps step over the slots)."""
    adj0, sel, beam = inputs(3, e, m0, ef, seed=e * 100 + m0)
    want = contract(adj0, sel, beam)
    got = kernel_model(adj0, sel, beam)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    adj0, sel, beam = (torch.from_numpy(a) for a in inputs(37, 3, 7, 50, 5))
    before = expand.hop_expand.launches
    got = expand.hop_expand(adj0, sel, beam)
    want = expand.hop_expand_plain(adj0, sel, beam)
    assert expand.hop_expand.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_check_refuses_what_the_kernel_cannot_take():
    """CPU tensors, and a mix with another device, are refused before any
    pointer is passed (the card test adds dtypes, strides and widths)."""
    adj0, sel, beam = (torch.from_numpy(a) for a in inputs(4, 4, 32, 200, 1))
    with pytest.raises(ValueError):
        expand._check(adj0, sel, beam)
    with pytest.raises(ValueError):
        expand.hop_expand(adj0, sel, beam.to("meta"))


@pytest.fixture(scope="module")
def small_index():
    data = generate_vectors(700, 32, distribution="embedding",
                            num_clusters=8, seed=3)
    return build_hnsw_index(data[:600], M=8, device="cpu"), data[600:632]


@pytest.mark.parametrize("kernel", [False, True])
def test_counter_counts_the_bodies_that_launched_the_kernel(
        kernel, small_index, monkeypatch):
    """The card's fixed-length loop, forced on the CPU: with the plain
    version no body counts; with a stand-in kernel (the plain version that
    counts a launch) every body does, and the rows are the same."""
    index, q = small_index
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    if kernel:
        def counting(adj0, sel_ids, beam_ids):
            counting.launches += 1
            return expand.hop_expand_plain(adj0, sel_ids, beam_ids)
        counting.launches = 0
        monkeypatch.setattr(expand, "hop_expand", counting)
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
    assert c["hop.bodies_run"] == 200 // 4 + 12
    assert c["hop.expand_kernel_bodies"] == (c["hop.bodies_run"] if kernel
                                             else 0)

"""The plan of the greedy-descent kernel
(csrc/descent.cu:descent_block_kernel), held on the CPU by a small Python
model read from the constants of the source.

1. The step: every (row, 16-byte chunk) of a neighbourhood scored exactly
   once across the block's lanes, no chunk of a padding row (id -1); every
   row's distance key stored once, by the lane that finishes the row.
2. The ids ahead: the next step's id rows (each neighbour's, and the row on
   the layer below) fetched once each, in 16-byte pieces at 16-byte offsets
   where M is a multiple of 4.
3. The shared memory: its regions in order and apart, at most what a block
   can have, an M whose ids do not fit refused; the queries an SM at the
   main path, set by registers.
4. The sources: chip_smoke.py names the kernel, and the wrapper asks the
   kernel's own plan for its shared memory.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hnsw_tpu_torch.ops import _cuda, descent

REPO = pathlib.Path(__file__).resolve().parent.parent
DESCENT_CU = REPO / "hnsw_tpu_torch" / "csrc" / "descent.cu"
CODE = DESCENT_CU.read_text()
# the shared memory and 32-bit registers of an H100 SM, and the shared
# memory the card reserves for a block
SM_SMEM, SM_REGS, BLOCK_RESERVED = 233472, 65536, 1024


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the test workers that share the host keep their
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", CODE)
    assert m, f"{name} is not where this test reads it"
    return _c_expr(m.group(1))


def _c_expr(text, **names):
    """Evaluate a C expression of ternaries, comparisons and && over names."""
    def py(s):
        s = s.strip()
        while s.startswith("(") and _close(s, 0) == len(s) - 1:
            s = s[1:-1].strip()
        depth = 0
        for i, ch in enumerate(s):
            depth += (ch == "(") - (ch == ")")
            if ch == "?" and depth == 0:
                nest = inner = 0
                for j in range(i + 1, len(s)):
                    inner += (s[j] == "(") - (s[j] == ")")
                    if inner == 0 and s[j] == "?":
                        nest += 1
                    elif inner == 0 and s[j] == ":":
                        if nest == 0:
                            return (f"(({py(s[i + 1:j])}) if ({py(s[:i])}) "
                                    f"else ({py(s[j + 1:])}))")
                        nest -= 1
        # no ternary at this level: translate the groups in parentheses
        out, i = [], 0
        while i < len(s):
            if s[i] == "(":
                j = _close(s, i)
                out.append(f"({py(s[i + 1:j])})")
                i = j + 1
            else:
                out.append(s[i])
                i += 1
        return "".join(out).replace("&&", " and ").replace("||", " or ")
    return eval(py(text), {}, names)


def _close(s, i):
    depth = 0
    for j in range(i, len(s)):
        depth += (s[j] == "(") - (s[j] == ")")
        if depth == 0:
            return j
    return -1


def _source(pattern):
    """The first group of `pattern` in descent.cu, found once."""
    found = re.findall(pattern, CODE)
    assert len(found) == 1, f"{pattern} is not where this test reads it"
    return found[0]


WARPS, MIN_BLOCKS = _constant("kWarps"), _constant("kMinBlocks")
SMEM_MAX, MIN_LANES = _constant("kSmemMax"), _constant("kMinLanes")
THREADS = 32 * WARPS
BATCH_STEPS = _source(
    r"constexpr int batch_steps\([^)]*\) \{\s*return ([^;]+);")
# make_plan's layout: the id buffers' offset and the block's shared memory
IDS_OFF = _source(r"p\.ids_off = ([^;]+);")
SMEM = _source(r"const long long smem = ([^;]+);").replace("p.", "") \
    .replace("2LL", "2")


def batch_steps(nc, elem):
    return _c_expr(BATCH_STEPS, nc=nc, bytes=elem)


def model_plan(m, d, elem):
    """make_plan of descent.cu: (chunks, lanes, per_lane, ahead, ids_off,
    smem, vec, per_row, dk, dc), or None where the ids do not fit."""
    chunks = d * elem // 16
    lanes = MIN_LANES
    while lanes < chunks and lanes < 32:
        lanes *= 2
    ids_off = _c_expr(IDS_OFF, M=m)
    for ahead in (1, 0):
        smem = _c_expr(SMEM, ids_off=ids_off, ahead=ahead, M=m)
        if smem <= SMEM_MAX:
            per_row = m // 4 if m % 4 == 0 else m
            return (chunks, lanes, -(-chunks // lanes), ahead, ids_off, smem,
                    int(m % 4 == 0), per_row, THREADS // per_row,
                    THREADS % per_row)
    return None


def nc_of(per_lane):
    return 1 if per_lane <= 1 else 3 if per_lane <= 3 else \
        6 if per_lane <= 6 else 0


def step(m, d, elem, ids):
    """One step of the kernel: the scored count of every (row, chunk), and
    the count of each row's distance key stored (by the lane that finishes
    the row)."""
    chunks, lanes, per_lane = model_plan(m, d, elem)[:3]
    nc = nc_of(per_lane)
    G = batch_steps(nc, elem)
    ncr, passes = (nc, 1) if nc else (1, per_lane)
    R = 32 // lanes
    wsteps = -(-m // R)
    scored = np.zeros((m, chunks), np.int64)
    stored = np.zeros(m, np.int64)
    lane = np.arange(32)
    slot, sub = lane // lanes, lane & (lanes - 1)
    for warp in range(WARPS):
        for s0 in range(warp, wsteps, WARPS * G):
            for g in range(G):
                rr = (s0 + g * WARPS) * R + slot
                for ps in range(passes):
                    for i in range(ncr):
                        c = sub + (i if nc else ps) * lanes
                        ok = (rr < m) & (c < chunks)
                        ok &= np.array([r < m and ids[r] >= 0 for r in rr])
                        np.add.at(scored, (rr[ok], c[ok]), 1)
            # the halving reduction leaves row g in the lanes with
            # sub // (lanes // G) == g; the first of them stores it
            part = lanes // G
            g = sub // part
            rr_g = (s0 + g * WARPS) * R + slot
            keep = (sub % part == 0) & (rr_g < m)
            np.add.at(stored, rr_g[keep], 1)
    return scored, stored


SHAPES = [(d, elem, m) for d in (64, 128, 768, 2064) for elem in (2, 4)
          for m in (8, 16, 32, 10)]


def _ids(m, n_pad, seed, pad=0.25):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_pad, m)
    ids[rng.random(m) < pad] = -1
    ids[0] = n_pad - 1          # the last row
    return ids


# ---------------------------------------------------------------------------
# 1. the step
# ---------------------------------------------------------------------------

# rows of one to three 16-byte chunks: four lanes a row at the least
SMALL = [(8, 2, 16), (16, 2, 10), (4, 4, 8), (24, 2, 32)]


@pytest.mark.parametrize("pad", [0.0, 0.25, 0.9], ids=["full", "some", "few"])
@pytest.mark.parametrize("d,elem,m", SHAPES + SMALL)
def test_every_chunk_is_scored_once(d, elem, m, pad):
    """Neighbourhoods with no padding rows, a quarter, and all but the
    first."""
    ids = _ids(m, 50, d * 7 + m, pad)
    scored, stored = step(m, d, elem, ids)
    valid = ids >= 0
    assert (scored[valid] == 1).all()
    assert (scored[~valid] == 0).all()
    assert (stored == 1).all()


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 70), d8=st.integers(8, 258),
       elem=st.sampled_from([2, 4]), seed=st.integers(0, 1000))
def test_every_chunk_is_scored_once_anywhere(m, d8, elem, seed):
    d = 8 * d8 if elem == 2 else 4 * d8
    ids = _ids(m, 40, seed)
    scored, stored = step(m, d, elem, ids)
    assert (scored[ids >= 0] == 1).all() and (scored[ids < 0] == 0).all()
    assert (stored == 1).all()


def test_main_path_plan():
    # 31,173 x 768 bf16, M = 16: three chunks a lane, one row a warp-step,
    # four rows a warp, ids ahead
    chunks, lanes, per_lane, ahead = model_plan(16, 768, 2)[:4]
    assert (chunks, lanes, per_lane, ahead) == (96, 32, 3, 1)
    assert -(-16 // (32 // lanes)) // WARPS == 4
    # a warp's four rows in one batch, 12 loads of 16 bytes a lane in
    # flight: the whole neighbourhood across the block
    assert batch_steps(3, 2) * per_lane == 12
    assert batch_steps(3, 2) * WARPS == 16
    # f32 (the euclidean check): six chunks a lane
    assert model_plan(16, 768, 4)[2:4] == (6, 1)


# ---------------------------------------------------------------------------
# 2. the ids ahead
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 16, 32, 10, 7, 64])
@pytest.mark.parametrize("below", [True, False])
def test_next_ids_are_fetched_once(m, below):
    """fetch_ids over the block's threads, stepping as the kernel steps
    (first piece t = (t / per_row, t % per_row), then (dk, dc) on): rows
    0..M-1 the neighbours', row M the layer below (not on the lowest
    layer)."""
    _, _, _, ahead, ids_off, _, vec, per_row, dk, dc = model_plan(m, 768, 2)
    w = 4 if vec else 1
    assert (per_row, dk, dc) == (m // w, THREADS // (m // w),
                                 THREADS % (m // w))
    slots = m + 1 if ahead else 1
    count = (m + 1 if below else m) if ahead else 1
    seen = np.zeros((count, m), np.int64)
    for parity in (0, 1):
        base = ids_off + parity * slots * m * 4
        for t in range(THREADS):
            k, c = t // per_row, t % per_row
            while k < count:
                at = c * w
                if vec:
                    assert (base + (k * m + at) * 4) % 16 == 0
                    assert (at * 4) % 16 == 0     # in the source row
                seen[k, at:at + w] += 1
                k, c = k + dk, c + dc
                if c >= per_row:
                    k, c = k + 1, c - per_row
    assert (seen == 2).all()
    assert vec == (m % 4 == 0)


# ---------------------------------------------------------------------------
# 3. the shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,elem,m", SHAPES + [(768, 2, 200), (64, 4, 1000)])
def test_shared_memory_regions_are_apart(d, elem, m):
    ahead, ids_off, smem = model_plan(m, d, elem)[3:6]
    slots = m + 1 if ahead else 1
    # two buffers of the rows' keys, two of their ids, two of id rows: in
    # order, apart
    regions = [(0, 8 * m), (8 * m, 16 * m),
               (ids_off, ids_off + 2 * slots * m * 4)]
    for (a0, a1), (b0, b1) in zip(regions, regions[1:]):
        assert a0 < a1 <= b0
    assert regions[-1][1] == smem <= SMEM_MAX
    assert ids_off % 16 == 0


def test_four_queries_an_sm_at_the_main_path():
    """At D = 768 bf16 the launch bounds ask for four blocks an SM, and
    registers, not shared memory, set that: four blocks of 128 threads at
    128 registers fill the register file, while the shared memory would
    hold more than eight. Eight an SM (a batch of 1,024 in one wave) was
    the first target; `blocks_6` and `blocks_8` of
    scripts/descent_ablate.py, which force 85 and 64 registers, were
    slower (PERF.md, section 6), so the kernel keeps four."""
    assert MIN_BLOCKS == 4
    assert "__launch_bounds__(kThreads, kMinBlocks)" in CODE
    assert SM_REGS // (THREADS * 128) == MIN_BLOCKS
    for elem in (2, 4):
        smem = model_plan(16, 768, elem)[5]
        assert 8 * (smem + BLOCK_RESERVED) <= SM_SMEM


def test_a_plan_that_cannot_fit_is_refused():
    assert model_plan(100_000, 64, 2) is None
    assert model_plan(10_000, 64, 2) is None
    assert model_plan(200, 768, 2)[3] == 0
    assert model_plan(64, 768, 2)[3] == 1
    # no plan: the launch refuses, and the wrapper's check asks first
    assert "if (plan.smem == 0) return (int)cudaErrorInvalidValue;" in CODE


# ---------------------------------------------------------------------------
# 4. the sources
# ---------------------------------------------------------------------------

def test_chip_smoke_names_the_block_kernel():
    from tests.test_torch_kernel_plan import _kernel_entries
    assert _kernel_entries()["greedy_descent"] == (
        "descent.cu", "20descent_block_kernelI13__nv_bfloat16Li0ELi3E")
    assert "wgmma" not in CODE
    # the earlier loop, one warp a query, is gone
    assert "descent_kernel(" not in CODE.replace("descent_block_kernel(", "")


def test_wrapper_asks_the_kernels_plan(monkeypatch):
    """ops/descent.py keeps no copy of the plan: its shared_bytes is the C
    entry's answer, which make_plan gives."""
    assert _cuda.SIGNATURES["descent.cu"]["greedy_descent_shared_bytes"] \
        == (_cuda.ctypes.c_int,) * 3
    assert re.search(r'extern "C" int greedy_descent_shared_bytes\(int M, '
                     r'int D, int bytes\) \{\s*return M > 0 \? '
                     r'make_plan\(M, D, bytes\)\.smem : 0;', CODE)
    asked = []

    def entry(name):
        assert name == "greedy_descent_shared_bytes"
        return lambda m, d, elem: asked.append((m, d, elem)) or \
            (model_plan(m, d, elem) or [0] * 6)[5]

    monkeypatch.setattr(descent, "_entry", entry)
    descent.shared_bytes.cache_clear()
    try:
        assert descent.shared_bytes(16, 768, 2) == model_plan(16, 768, 2)[5]
        assert descent.shared_bytes(10_000, 64, 2) == 0
    finally:
        descent.shared_bytes.cache_clear()
    assert asked == [(16, 768, 2), (10_000, 64, 2)]

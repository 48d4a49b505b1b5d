"""The plan of the bf16 hop kernel (csrc/hop.cu:hop_bf16_ring_kernel), held on
the CPU by a small Python model read from the constants of the source.

1. The walk: the groups of every selected block (whole rows of one stage, or
   one row in pieces) split into contiguous ranges over the persistent
   blocks, each block within one group of the others, each consumer warp
   taking the groups w, w + 8, ... of its range, and the producer stepping
   its group index instead of dividing.
2. The cut: each group's stages are at most kStageBytes, multiples of 16
   bytes at 16-byte offsets, and cover the block's bytes once.
3. The lanes: the (row, 16-byte chunk) each lane reads in each warp-step,
   at D = 16, 128, 768 and 2,064 (and rows in pieces), so that every
   (b, e, m, chunk) is read exactly once, every lane has work at D = 128
   and 768, and the row each lane keeps after the reduction is the row its
   window stores.
4. The sources: chip_smoke.py names the kernel, the wrapper's shared-memory
   figure is the ring's, and the ablation script's pieces are in hop.cu.
5. The int8 kernel (hop_int8_kernel<LANES, NC, UNIT>): its plan (16- or
   8-byte units, lanes a row, units a lane a pass, passes, tasks of
   kI8Steps warp-steps, warps a query), the warps' tasks and lanes, so that
   every (b, e, m, 16-byte chunk) is read exactly once (both 8-byte halves,
   where the units are 8 bytes) at D = 16, 128, 768 and 2,064 and every
   lane has work at D = 128 and 768, and the halving exchanges of its reduction,
   so that the row a lane stores is the row whose lanes' sums it holds and
   every row is stored once; chip_smoke.py and the ablation script name its
   instantiations and pieces.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hnsw_tpu_torch.ops import hop

REPO = pathlib.Path(__file__).resolve().parent.parent
HOP_CU = REPO / "hnsw_tpu_torch" / "csrc" / "hop.cu"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _constants():
    code = HOP_CU.read_text()
    out = {}
    for name in ("kConsumerWarps", "kStageBytes", "kStages", "kBlocksPerSM",
                 "kRegChunks"):
        m = re.search(rf"constexpr int {name} = (\d+);", code)
        assert m, f"{name} is not where this test reads it"
        out[name] = int(m.group(1))
    return out


K = _constants()
WARPS, STAGE, STAGES = K["kConsumerWarps"], K["kStageBytes"], K["kStages"]


def ring_plan(m0, d):
    """ring_plan of hop.cu: chunks, lanes, per_lane, rows, pieces, groups."""
    row_bytes, chunks = 2 * d, d // 8
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    per_lane = -(-chunks // lanes)
    if row_bytes <= STAGE:
        rows = min(m0, STAGE // row_bytes)
        return chunks, lanes, per_lane, rows, 1, -(-m0 // rows)
    return chunks, lanes, per_lane, 0, -(-row_bytes // STAGE), m0


def block_ranges(total, sms):
    """The persistent blocks' ranges of groups: [g0, g0 + n) per block."""
    grid = min(total, sms * K["kBlocksPerSM"])
    return [(total * k // grid, total * (k + 1) // grid - total * k // grid)
            for k in range(grid)]


def decode(g, e_count, groups):
    b, r = divmod(g, e_count * groups)
    e, gi = divmod(r, groups)
    return b, e, gi


def walk(b_count, e_count, m0, d, sms):
    """Model the kernel: returns the read count of every (b, e, m, chunk),
    the stages as (block, j, slot, parity, offset, bytes) and the group
    counts per block."""
    chunks, lanes, per_lane, rows, pieces, groups = ring_plan(m0, d)
    row_bytes = 2 * d
    reads = np.zeros((b_count, e_count, m0, chunks), np.int64)
    stages, per_block = [], []
    R = 32 // lanes
    lane = np.arange(32)
    my_row, sub = lane // lanes, lane & (lanes - 1)
    for blk, (g0, n) in enumerate(block_ranges(b_count * e_count * groups,
                                               sms)):
        per_block.append(n)
        # the producer steps its group index along with i from r0's
        r0 = g0 % (e_count * groups)
        gi = r0 % groups
        for i in range(n):
            assert decode(g0 + i, e_count, groups)[2] == gi
            gi = (gi + 1) % groups
        for warp in range(WARPS):
            for i in range(warp, n, WARPS):
                b, e, gi = decode(g0 + i, e_count, groups)
                if rows:
                    first, nr = gi * rows, min(rows, m0 - gi * rows)
                    j = i
                    stages.append((blk, j, j % STAGES, (j // STAGES) & 1,
                                   first * row_bytes, nr * row_bytes))
                    written = []
                    for step in range(-(-nr // R)):
                        row = step * R + my_row
                        for k in range(per_lane):
                            c = sub + k * lanes
                            ok = (row < nr) & (c < chunks)
                            np.add.at(reads[b, e], (first + row[ok], c[ok]), 1)
                        written += _window_rows(step, R, lanes, nr)
                    assert sorted(written) == list(range(nr))
                else:
                    per_stage = STAGE // 16
                    for p in range(pieces):
                        j = i * pieces + p
                        piece = min(STAGE, row_bytes - p * STAGE)
                        stages.append((blk, j, j % STAGES, (j // STAGES) & 1,
                                       gi * row_bytes + p * STAGE, piece))
                        c0 = p * per_stage
                        cn = min(per_stage, chunks - c0)
                        assert piece == cn * 16
                        for c in range(0, cn, 32):
                            ok = c + lane < cn
                            np.add.at(reads[b, e, gi], c0 + c + lane[ok], 1)
    return reads, stages, per_block


def _window_rows(step, R, lanes, nr):
    """The rows stored after `step`: the lane that keeps window row x takes
    it from the lane holding that row after the reduction (the first lane
    of its row group), and the window is stored at its last step or the
    stage's last."""
    lane = np.arange(32)
    keep_step, keep_src = lane // R, (lane & (R - 1)) * lanes
    in_window = step & (lanes - 1)
    # after the reduction lane t * lanes holds row step * R + t
    held = {t * lanes: step * R + t for t in range(R)}
    window0 = (step - in_window) * R
    for x in lane[keep_step == in_window]:
        assert held[int(keep_src[x])] == window0 + x
    if in_window == lanes - 1 or (step + 1) * R >= nr:
        return [int(m) for m in window0 + lane if m < nr]
    return []


# ---------------------------------------------------------------------------
# 1-3. the walk, the cut and the lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,e,m0,d,sms", [
    (1, 4, 32, 768, 132), (5, 3, 8, 128, 132), (37, 3, 7, 768, 132),
    (40, 4, 32, 768, 3), (6, 2, 9, 128, 2), (3, 5, 11, 1536, 132),
    (2, 2, 5, 2064, 132), (4, 1, 3, 16, 132), (3, 2, 96, 128, 5),
    (3, 2, 3, 6160, 2), (2, 2, 2, 16384, 132), (64, 4, 32, 128, 7)])
def test_every_chunk_is_read_once(b, e, m0, d, sms):
    reads, stages, per_block = walk(b, e, m0, d, sms)
    assert (reads == 1).all()
    assert max(per_block) - min(per_block) <= 1
    row_bytes = 2 * d
    for blk in {s[0] for s in stages}:
        mine = sorted(s[1:] for s in stages if s[0] == blk)
        assert [s[0] for s in mine] == list(range(len(mine)))
    for _, _, slot, parity, offset, nbytes in stages:
        assert 0 < nbytes <= STAGE and nbytes % 16 == 0 and offset % 16 == 0
        assert 0 <= slot < STAGES and parity in (0, 1)
        assert offset + nbytes <= m0 * row_bytes


@settings(max_examples=30, deadline=None)
@given(b=st.integers(1, 9), e=st.integers(1, 5), m0=st.integers(1, 40),
       d16=st.sampled_from([1, 2, 3, 5, 8, 13, 48, 129, 386, 1024]),
       sms=st.integers(1, 20))
def test_every_chunk_is_read_once_anywhere(b, e, m0, d16, sms):
    reads, _, per_block = walk(b, e, m0, 16 * d16, sms)
    assert (reads == 1).all()
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("d,lanes,rows_a_step,per_lane", [
    (16, 2, 16, 1), (128, 16, 2, 1), (768, 32, 1, 3), (2064, 32, 1, 9)])
def test_lane_map(d, lanes, rows_a_step, per_lane):
    chunks, got_lanes, got_per_lane, rows, pieces, _ = ring_plan(32, d)
    assert (got_lanes, 32 // got_lanes, got_per_lane) == (
        lanes, rows_a_step, per_lane)
    assert rows > 0 and pieces == 1
    # the lanes' chunks of one warp-step
    lane = np.arange(32)
    taken = [(lane // lanes, (lane & (lanes - 1)) + k * lanes)
             for k in range(per_lane)]
    busy = np.zeros(32, bool)
    for _, c in taken:
        busy |= c < chunks
    if d in (128, 768):
        # every lane has work in every chunk slot of every step
        assert all((c < chunks).all() for _, c in taken)
    assert busy.all()


@pytest.mark.parametrize("d,nc", [(16, 1), (128, 1), (256, 1), (512, 3),
                                  (768, 3), (1024, 0), (2064, 0),
                                  (16384, 0)])
def test_query_slice_in_registers_up_to_three_chunks_a_lane(d, nc):
    """The instantiation the entry point picks: NC chunks a lane with the
    query slice in registers (at D = 512 the third reads zeros), or 0 (read
    per chunk)."""
    _, _, per_lane, rows, _, _ = ring_plan(32, d)
    regs = K["kRegChunks"]
    got = 0 if rows == 0 or per_lane > regs else (1 if per_lane == 1 else regs)
    assert got == nc


def test_main_path_plans():
    # (a) / (b): 8 rows of 1,536 bytes a stage, four stages a block;
    # (c): the whole 8 KiB block in one stage
    assert ring_plan(32, 768) == (96, 32, 3, 8, 1, 4)
    assert ring_plan(32, 128) == (16, 16, 1, 32, 1, 1)
    # the rows of a stage fill it exactly at D = 768
    assert 8 * 2 * 768 == STAGE
    # at least 64 KiB in flight per SM
    assert STAGES * 8 * 1024 * K["kBlocksPerSM"] >= 64 * 1024


# ---------------------------------------------------------------------------
# 4. the sources
# ---------------------------------------------------------------------------

def test_ring_fits_shared_memory():
    smem = STAGES * (STAGE + 2 * 8) + 16
    assert hop.RING_SMEM_BYTES == smem
    # 227 KB a block, less the 1 KB the card reserves for each
    assert K["kBlocksPerSM"] * (smem + 1024) <= 232448 + 1024


def test_chip_smoke_names_the_ring_kernel():
    from tests.test_torch_kernel_plan import _kernel_entries
    assert _kernel_entries()["hop_score"] == (
        "hop.cu", "20hop_bf16_ring_kernelILi3E")
    code = HOP_CU.read_text()
    body = code.split("hop_bf16_ring_kernel(", 1)[1].split("\n}\n", 1)[0]
    for piece in ("cp.async.bulk", "mbar_expect_tx(", "mbar_wait(",
                  "bulk_load("):
        assert piece in code, piece
    assert "bulk_load(" in body and "mbar_arrive(" in body
    assert "wgmma" not in body
    # the old one-block-per-query loop is gone
    assert "hop_bf16_kernel(" not in code


def _ablate():
    spec = importlib.util.spec_from_file_location(
        "hop_ablate", REPO / "scripts" / "hop_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", sorted(_ablate().VARIANTS))
def test_each_ablation_finds_its_pieces(variant):
    """Each edit finds its piece once, applied in order as the script
    applies them."""
    code = HOP_CU.read_text()
    for old, new in _ablate().VARIANTS[variant]:
        assert code.count(old) == 1, (variant, old)
        code = code.replace(old, new)


@pytest.mark.parametrize("case,shown", [
    ("dtype", "pack torch.float32 (4, 8, 32)"),
    ("d", "pack torch.bfloat16 (4, 8, 24)"),
    ("queries", "queries torch.float32 (2, 16)"),
    ("rows", "sel_rows torch.int32 (3, 1)"),
    ("sel", "sel_rows torch.int64 (2, 1)")])
def test_wrapper_check_refuses_with_a_message(case, shown):
    """The lean check raises ValueError and only then formats what it got
    (on the CPU every operand also fails the CUDA-device test)."""
    pack = torch.zeros((4, 8, 32), dtype=torch.bfloat16)
    q = torch.zeros((2, 32))
    sel = torch.zeros((2, 1), dtype=torch.int32)
    if case == "dtype":
        pack = pack.float()
    elif case == "d":
        pack, q = pack[:, :, :24].contiguous(), q[:, :24].contiguous()
    elif case == "queries":
        q = q[:, :16].contiguous()
    elif case == "rows":
        sel = torch.zeros((3, 1), dtype=torch.int32)
    else:
        sel = sel.long()
    with pytest.raises(ValueError) as info:
        hop._check(pack, q, sel, torch.bfloat16)
    assert shown in str(info.value)


# ---------------------------------------------------------------------------
# 5. the int8 kernel
# ---------------------------------------------------------------------------

def _int8_constants():
    code = HOP_CU.read_text()
    out = {}
    for name in ("kI8Threads", "kI8RegUnits", "kI8Steps"):
        m = re.search(rf"constexpr int {name} = (\d+);", code)
        assert m, f"{name} is not where this test reads it"
        out[name] = int(m.group(1))
    assert "p.unit = fill(D / 8) > fill(D / 16) ? 8 : 16;" in code
    return out


K8 = _int8_constants()
I8_WARPS = K8["kI8Threads"] // 32
# the card's warps at once, at glove's plan (132 SMs x 8 blocks x 4 warps)
RESIDENT = 4224


def i8_lanes(units):
    lanes = 1
    while lanes < units and lanes < 32:
        lanes *= 2
    return lanes


def i8_plan(e, m0, d, b=1, resident=RESIDENT):
    """i8_plan of hop.cu and the entry point's parts: unit, units, lanes,
    nc, passes, tasks, parts."""
    def fill(units):
        lanes = i8_lanes(units)
        return units / (lanes * -(-units // lanes))
    unit = 8 if fill(d // 8) > fill(d // 16) else 16
    units = d // unit
    lanes = i8_lanes(units)
    per_lane = -(-units // lanes)
    nc = min(per_lane, K8["kI8RegUnits"])
    passes = -(-per_lane // nc)
    steps = -(-(e * m0) // (32 // lanes))
    tasks = -(-steps // K8["kI8Steps"])
    fit = resident // b
    parts = 1 if fit < 1 else min(fit, tasks)
    return unit, units, lanes, nc, passes, tasks, parts


def i8_reduction(lanes, s):
    """The halving exchanges of one task, each lane's partial sum of step u
    written (u, lane): for each lane, its first step `base` and the sums it
    holds after the rounds, as sets of (u, lane)."""
    lane = np.arange(32)
    sub = lane & (lanes - 1)
    acc = [[{(u, x)} for u in range(s)] for x in range(32)]
    base = [0] * 32
    for i in range(int(np.log2(lanes))):
        off, half = lanes >> (i + 1), s >> (i + 1)
        new = [list(a) for a in acc]
        for x in range(32):
            y = x ^ off
            if half > 0:
                upper, y_upper = bool(sub[x] & off), bool(sub[y] & off)
                for j in range(half):
                    sent = acc[y][j] if y_upper else acc[y][half + j]
                    keep = acc[x][half + j] if upper else acc[x][j]
                    new[x][j] = keep | sent
                if upper:
                    base[x] += half
            else:
                new[x][0] = acc[x][0] | acc[y][0]
        acc = new
    return base, acc


def i8_walk(b_count, e_count, m0, d, resident=RESIDENT):
    """Model the kernel: the read count of the two 8-byte halves of every
    (b, e, m, 16-byte chunk), the store count of every (b, row), and the
    lanes that loaded a unit."""
    unit, units, lanes, nc, passes, tasks, parts = i8_plan(
        e_count, m0, d, b_count, resident)
    R, S = 32 // lanes, K8["kI8Steps"]
    V, DUP = max(1, S // lanes), max(1, lanes // S)
    C = e_count * m0
    lane = np.arange(32)
    my_row, sub = lane // lanes, lane & (lanes - 1)
    base, held = i8_reduction(lanes, S)
    # the row a lane stores is the one whose lanes' partial sums it holds
    for x in range(32):
        for j in range(V):
            assert held[x][j] == {(base[x] + j, y) for y in range(32)
                                  if my_row[y] == my_row[x]}
    stores = (sub & (DUP - 1)) == 0
    reads = np.zeros((b_count, e_count, m0, d // 16, 2), np.int64)
    stored = np.zeros((b_count, C), np.int64)
    busy = np.zeros(32, bool)
    blocks = -(-(b_count * parts) // I8_WARPS)
    for w in range(blocks * I8_WARPS):
        if w >= b_count * parts:
            continue
        b, part = divmod(w, parts)
        for t in range(part, tasks, parts):
            # the kernel's stepping of (r, e, m): one division a task
            r = t * S * R + my_row
            e, m = r // m0, r % m0
            for u in range(S):
                assert ((e * m0 + m) == r).all()
                for p in range(passes):
                    for k in range(nc):
                        c = (p * nc + k) * lanes + sub
                        ok = (r < C) & (c < units)
                        # the unit's 8-byte pieces
                        for h in range(unit // 8):
                            piece = c * (unit // 8) + h
                            np.add.at(reads[b], (e[ok], m[ok], piece[ok] // 2,
                                                 piece[ok] % 2), 1)
                        busy |= ok
                r = r + R
                m = m + R
                while (m >= m0).any():
                    e = e + (m >= m0)
                    m = np.where(m >= m0, m - m0, m)
            for x in lane[stores]:
                for j in range(V):
                    row = (t * S + base[x] + j) * R + my_row[x]
                    if row < C:
                        stored[b, row] += 1
    return reads, stored, busy


@pytest.mark.parametrize("b,e,m0,d,resident", [
    (8, 4, 32, 128, 32), (5, 3, 7, 128, RESIDENT), (3, 4, 32, 768, 12),
    (2, 3, 7, 768, RESIDENT), (4, 1, 3, 16, RESIDENT), (3, 2, 40, 16, 5),
    (2, 2, 5, 2064, RESIDENT), (3, 3, 11, 2064, 2), (2, 5, 11, 1536, 7),
    (6, 2, 9, 256, 1), (3, 2, 9, 32, RESIDENT), (2, 3, 13, 64, 4),
    (1, 4, 32, 512, RESIDENT), (2, 2, 3, 6160, RESIDENT),
    (2, 3, 5, 640, 3), (2, 2, 7, 1024, RESIDENT)])
def test_int8_every_chunk_is_read_once(b, e, m0, d, resident):
    reads, stored, busy = i8_walk(b, e, m0, d, resident)
    assert (reads == 1).all()
    assert (stored == 1).all()
    if d in (128, 768):
        assert busy.all()


@settings(max_examples=25, deadline=None)
@given(b=st.integers(1, 6), e=st.integers(1, 5), m0=st.integers(1, 40),
       d16=st.sampled_from([1, 2, 3, 5, 8, 13, 16, 33, 40, 48, 129, 386]),
       resident=st.integers(1, 64))
def test_int8_every_chunk_is_read_once_anywhere(b, e, m0, d16, resident):
    reads, stored, _ = i8_walk(b, e, m0, 16 * d16, resident)
    assert (reads == 1).all()
    assert (stored == 1).all()


@pytest.mark.parametrize("d,unit,lanes,rows_a_step,nc,passes", [
    (16, 16, 1, 32, 1, 1), (128, 16, 8, 4, 1, 1), (768, 8, 32, 1, 3, 1),
    (1536, 16, 32, 1, 3, 1), (2064, 8, 32, 1, 3, 3)])
def test_int8_lane_map(d, unit, lanes, rows_a_step, nc, passes):
    """Bytes a unit, lanes a row, rows a warp-step, units a lane a pass and
    passes; at D = 128 and 768 every lane loads a unit in every warp-step,
    and at D = 768 every unit slot of a lane holds a unit of the row."""
    got_unit, units, got_lanes, got_nc, got_passes, _, _ = i8_plan(4, 32, d)
    assert (got_unit, got_lanes, 32 // got_lanes, got_nc, got_passes) == (
        unit, lanes, rows_a_step, nc, passes)
    sub = np.arange(32) & (lanes - 1)
    if d in (128, 768):
        assert (sub < units).all()
    if d == 768:
        assert units == 32 * nc * passes
    # the units of a row are split over its lanes with none left over
    taken = sorted(int(c) for p in range(passes) for k in range(nc)
                   for c in (p * nc + k) * lanes + np.arange(lanes)
                   if c < units)
    assert taken == list(range(units))


def test_int8_glove_plan():
    """Glove's hop (B 1,024, E 4, M0 32, D 128): 16-byte units, eight lanes
    a row, four rows a step, eight tasks of four steps a query (half a
    block each), four warps a query where the card holds 4,224 warps at
    once. At D = 768 all lanes share a row, three 8-byte units a lane."""
    assert K8["kI8Steps"] == 4
    assert i8_plan(4, 32, 128, b=1024) == (16, 8, 8, 1, 1, 8, 4)
    assert i8_plan(4, 32, 768, b=1024) == (8, 96, 32, 3, 1, 32, 4)
    # 512 contiguous bytes a warp-step at D = 128
    assert 32 * 16 == 4 * 128


@pytest.mark.parametrize("lanes,s", [(1, 4), (2, 4), (4, 4), (8, 4),
                                     (16, 4), (32, 4), (8, 8), (32, 8)])
def test_int8_reduction_shuffles(lanes, s):
    """The halving exchanges: s - 1 shuffles a task where lanes >= s, each
    round after those one more; every lane ends with whole sums."""
    shuffles = sum(max(1, s >> (i + 1)) for i in range(int(np.log2(lanes))))
    want = (s - 1 + int(np.log2(lanes // s))) if lanes >= s else \
        s - s // lanes
    assert shuffles == want
    base, held = i8_reduction(lanes, s)
    for x in range(32):
        assert len(held[x][0]) == lanes


def test_int8_instantiations_cover_every_plan():
    """The entry point's switch names the instantiation of every plan."""
    code = HOP_CU.read_text()
    body = code.split("int i8_kernel(", 1)[1].split("\n}\n", 1)[0]
    made = set(re.findall(r"hop_int8_kernel<(\d+), (\w+), (\d+)>", body))
    want = {(str(lanes), "1", "16") for lanes in (1, 2, 4, 8, 16, 32)} | {
        ("32", "2", "16"), ("32", "kI8RegUnits", "16"),
        ("32", "kI8RegUnits", "8")}
    assert made == want and K8["kI8RegUnits"] == 3
    for d16 in range(1, 400):
        unit, _, lanes, nc, _, _, _ = i8_plan(4, 32, 16 * d16)
        assert nc == 1 or lanes == 32
        assert unit == 16 or (lanes, nc) == (32, 3)


def test_chip_smoke_names_the_int8_kernel():
    from tests.test_torch_kernel_plan import _kernel_entries
    assert _kernel_entries()["hop_score_int8"] == (
        "hop.cu", "15hop_int8_kernelILi8ELi1ELi16EE")
    code = HOP_CU.read_text()
    # the old plan of four rows a warp is gone
    assert "kI8Units" not in code and "kI8Rows" not in code


def _int8_ablate():
    spec = importlib.util.spec_from_file_location(
        "hop_int8_ablate", REPO / "scripts" / "hop_int8_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", sorted(_int8_ablate().VARIANTS))
def test_each_int8_ablation_finds_its_pieces(variant):
    code = HOP_CU.read_text()
    for old, new in _int8_ablate().VARIANTS[variant]:
        assert code.count(old) == 1, (variant, old)
        code = code.replace(old, new)

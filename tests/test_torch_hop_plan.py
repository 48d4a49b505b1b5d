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

"""The host-side model of the sweep kernels (csrc/sweep.cu), on the CPU.

The kernels cut each query's corpus columns into parts: S corpus splits,
and in each split the two consumer warpgroups, which take its 128-row tiles
in turn (ping-pong: consumer w the tiles t_begin + w, t_begin + w + 2, ...),
each tile whole, as two m64n64 wgmma (the accumulator layout modelled here
after column_of() in csrc/sweep.cu). Each part keeps its own sorted top-k
list and sweep_merge folds the 2 * S lists. These tests hold that design to
the plain version on the CPU:

1. The column-order property it rests on: the lexicographic top-k of the
   parts, each selected with the port's _tile_topk and folded with
   _merge_sorted, is _tile_topk over the whole matrix bit for bit, planted
   ties included, for any k, S and n (hypothesis). The same cut of
   exact_topk_sweep_plain matches the JAX pallas_exact_topk (interpret mode)
   at test_sweep_matches_pallas's tolerance and row order.
2. ops/scan.py:sweep_plan, the splits and partial lists the wrapper sizes
   its buffers by: never more lists than sweep.cu's kMaxLists.
3. The cheap test the kernels run before the exact cosine and euclidean
   distance, emulated in numpy float32 with the constants read from the
   source: it never rejects an element whose exact distance is at most the
   threshold, with rsqrtf off by up to 2 ulp and with or without the FMA
   contractions nvcc may form in the thresholds.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from hnsw_tpu.ops import pallas_scan as jscan
from hnsw_tpu.types import Metric as JMetric

from hnsw_tpu_torch.ops import scan
from tests.conftest import make_unit
from tests.test_torch_scan import (KEY_TOL, _assert_same_bank_order,
                                   _bf16_case, _port_args)

REPO = pathlib.Path(__file__).resolve().parent.parent
SWEEP_CU = (REPO / "hnsw_tpu_torch" / "csrc" / "sweep.cu").read_text()
BIG = 1e30
TILE = 128


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def thread_columns(lane: int) -> list:
    """The tile columns of a consumer thread: col0 + column_of(b), b < 32,
    col0 = 2 (lane % 4), column_of(b) = 64 (b / 16) + 8 (b % 16 / 2) + b % 2
    (csrc/sweep.cu), the same for each of its two rows."""
    col0 = 2 * (lane % 4)
    return [col0 + 64 * (b // 16) + 8 * (b % 16 // 2) + b % 2
            for b in range(32)]


def consumer_columns() -> list:
    """The columns of a tile a consumer warpgroup covers: the union over
    its 4 warps and 32 lanes of thread_columns()."""
    return sorted({c for _warp in range(4) for lane in range(32)
                   for c in thread_columns(lane)})


def kernel_parts(ntiles: int, splits: int) -> list:
    """Column indices of each partial list: split s walks the tiles
    [s * ntiles // S, (s + 1) * ntiles // S) as csrc/sweep.cu cuts them, and
    consumer w of it keeps consumer_columns() of its tiles lo + w, lo + w +
    2, ...; a split of one tile leaves consumer 1 an empty list."""
    parts = []
    for s in range(splits):
        lo, hi = s * ntiles // splits, (s + 1) * ntiles // splits
        for w in range(2):
            parts.append([t * TILE + c for t in range(lo + w, hi, 2)
                          for c in consumer_columns()])
    return parts


def fold(results, k: int):
    """sweep_merge: the sorted lists folded in the given order, with the
    plain version's (BIG, -1) for missing rows."""
    out_d, out_r = results[0]
    for d, r in results[1:]:
        out_d, out_r = scan._merge_sorted(torch.cat([out_d, d], dim=1),
                                          torch.cat([out_r, r], dim=1), k)
    return out_d, torch.where(out_d < BIG, out_r, -1)


def test_a_consumer_covers_each_of_its_tiles_whole():
    assert consumer_columns() == list(range(TILE))
    # a thread's 32 columns rise with b, so its live ones are a prefix
    for lane in range(32):
        cols = thread_columns(lane)
        assert cols == sorted(cols) and len(set(cols)) == 32


def _tied_matrix(rng, b: int, n_cols: int, n: int):
    """Distances on a coarse grid (many exact ties, in every part), one
    value planted in several parts of every row, rows >= n masked BIG as the
    plain version masks them."""
    dist = rng.integers(0, 40, (b, n_cols)).astype(np.float32) / 8
    planted = rng.choice(n_cols, size=min(12, n_cols), replace=False)
    dist[:, planted] = -1.0
    dist = torch.from_numpy(dist)
    rows = torch.arange(n_cols, dtype=torch.int32).expand(b, n_cols)
    return torch.where(rows < n, dist, BIG), rows


@settings(max_examples=30, deadline=None)
@given(k=st.integers(1, 32), splits=st.integers(1, 16),
       extra_tiles=st.integers(0, 3), cut=st.integers(0, 127),
       seed=st.integers(0, 2 ** 16))
def test_parts_fold_to_the_whole_top_k(k, splits, extra_tiles, cut, seed):
    ntiles = splits + extra_tiles
    n_cols = ntiles * TILE
    n = n_cols - cut                          # n % 128 != 0 unless cut = 0
    dist, rows = _tied_matrix(np.random.default_rng(seed), 6, n_cols, n)
    want_d, want_r = scan._tile_topk(dist, rows, k)
    want_r = torch.where(want_d < BIG, want_r, -1)
    results = [scan._tile_topk(dist[:, p], rows[:, p], k)
               for p in kernel_parts(ntiles, splits) if p]
    for order in (results, results[::-1]):   # any fold order
        got_d, got_r = fold(order, k)
        assert torch.equal(got_d, want_d)
        assert torch.equal(got_r, want_r)


def _cut_sweep(vb, vsq, qb, n: int, k: int, metric: str, splits: int):
    """exact_topk_sweep_plain over each part of the kernel's cut (the part's
    rows as a corpus of their own, in increasing order), rows mapped back,
    the parts folded."""
    vf = _port_args(vb, vsq, qb)
    n_pad = vf[0].shape[0]
    results = []
    for p in kernel_parts(n_pad // TILE, splits):
        if not p:
            continue
        idx = torch.tensor(p)
        n_part = int((idx < n).sum())
        d, r = scan.exact_topk_sweep_plain(vf[0][idx], vf[1][idx], vf[2],
                                           n_part, k=k, metric=metric,
                                           nt=TILE)
        results.append((d, torch.where(r >= 0, idx[r.clamp(min=0).long()]
                                       .to(torch.int32), -1)))
    return fold(results, k)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_kernel_cut_of_the_plain_sweep_matches_pallas(metric):
    data = make_unit(1000, 64, seed=71)
    n, vb, vsq, qb = _bf16_case(data, metric, 1024, 128)
    jd, jr = jscan.pallas_exact_topk(vb, jnp.asarray(vsq), qb, n, k=10,
                                     metric=JMetric(metric), bt=128, nt=256,
                                     interpret=True)
    for splits in (1, 2, 8):
        td, tr = _cut_sweep(vb, vsq, qb, n, 10, metric, splits)
        p = 2 if metric == "euclidean" else 1
        _assert_same_bank_order(td.numpy() ** p, tr.numpy(),
                                np.asarray(jd) ** p, jr, KEY_TOL)


def _max_lists() -> int:
    m = re.search(r"constexpr int kMaxLists = (\d+);", SWEEP_CU)
    assert m, "kMaxLists is not where this test reads it"
    return int(m.group(1))


@pytest.mark.parametrize("qblocks,ntiles,sms", [
    (1, 160, 132), (1, 1, 132), (1, 8, 132), (64, 248, 132), (64, 256, 132),
    (2, 32, 132), (132, 8, 132), (8, 1_000_000, 114),
    (1, 16 * 65535 + 7, 132), (200, 70_000, 132), (3, 5, 7)])
def test_sweep_plan_stays_under_the_merge_cap(qblocks, ntiles, sms):
    splits, lists = scan.sweep_plan(qblocks, ntiles, sms)
    assert scan.SWEEP_MAX_LISTS == _max_lists()
    assert lists == 2 * splits <= scan.SWEEP_MAX_LISTS
    assert 1 <= splits <= min(ntiles, 16)
    assert splits == min(scan.split_plan(qblocks, ntiles, sms), 16)


def test_sweep_plan_at_the_main_shapes():
    # B = 1 fills the card with one query block over 16 splits: 32 lists;
    # B = 4096 over the 31,744- and 32,768-row packs: 2 splits, 4 lists
    assert scan.sweep_plan(1, 160, 132) == (16, 32)
    assert scan.sweep_plan(64, 248, 132) == (2, 4)
    assert scan.sweep_plan(64, 256, 132) == (2, 4)


def test_chip_smoke_names_the_wgmma_sweep_kernels():
    from tests.test_torch_kernel_plan import _kernel_entries
    entries = _kernel_entries()
    assert entries["exact_topk_sweep"] == ("sweep.cu",
                                           "18sweep_wgmma_kernelILb0E")
    assert entries["int8_sweep_topk"] == ("sweep.cu",
                                          "18sweep_wgmma_kernelILb1E")
    assert "sweep_kernel<" not in SWEEP_CU.replace("sweep_wgmma_kernel<", "")


# ---------------------------------------------------------------------------
# the cheap test
# ---------------------------------------------------------------------------

def _constant(pattern: str) -> np.float32:
    m = re.search(pattern, SWEEP_CU)
    assert m, f"{pattern} is not in csrc/sweep.cu"
    return np.float32(m.group(1))


F = np.float32


def _fma(a, b, c):
    """fmaf in float32: the exact product and sum (float64 holds a float32
    product exactly), rounded once more."""
    return F(np.float64(a) * np.float64(b) + np.float64(c))


def _ulps(x, n: int):
    for _ in range(abs(n)):
        x = np.nextafter(x, F(np.inf if n > 0 else -np.inf), dtype=np.float32)
    return F(x)


def _cheap_inputs(seed: int, count: int):
    rng = np.random.default_rng(seed)
    qsq = F(10.0) ** rng.uniform(-14, 4, count).astype(F)
    vsq = F(10.0) ** rng.uniform(-14, 4, count).astype(F)
    vsq[::17] = 0.0
    ratio = rng.uniform(-1.3, 1.3, count).astype(F)
    dot = (ratio * np.sqrt(qsq.astype(np.float64) * vsq)).astype(F)
    dot[::13] = rng.standard_normal(dot[::13].shape).astype(F)
    return qsq, vsq, dot


@pytest.mark.parametrize("seed", range(3))
def test_cheap_cosine_test_never_rejects_a_kept_element(seed):
    k_ratio = _constant(r"kRatioSlack = ([0-9.e+-]+)f;")
    k_cut = _constant(r"kCutSlack = ([0-9.e+-]+)f;")
    assert k_ratio == F(2.0 ** -19) and k_cut == F(2.0 ** -20)
    qsq, vsq, dot = _cheap_inputs(seed, 4000)
    for q, v, x in zip(qsq, vsq, dot):
        m = np.maximum(F(q * v), F(1e-12))
        d = F(F(1.0) - F(x / F(np.sqrt(m))))          # distance(), exact
        t = d                                         # the tightest threshold
        cuts = (F(F(F(1.0) - t) - F(k_cut * F(abs(t) + F(1.0)))),
                _fma(-k_cut, F(abs(t) + F(1.0)), F(F(1.0) - t)))
        rs = F(1.0 / math.sqrt(float(m)))
        for off in range(-2, 3):                      # rsqrtf: 2 ulp
            r = F(x * _ulps(rs, off))
            hi = _fma(abs(r), k_ratio, r)
            assert all(hi >= c for c in cuts), (q, v, x, off)


@pytest.mark.parametrize("seed", range(3))
def test_cheap_euclidean_test_never_rejects_a_kept_element(seed):
    grow = _constant(r"wd\[H\] \* wd\[H\] \* ([0-9.]+)f")
    floor = _constant(r"\* [0-9.]+f \+ ([0-9.e+-]+)f;")
    qsq, vsq, dot = _cheap_inputs(seed + 10, 4000)
    for q, v, x in zip(qsq, vsq, dot):
        s = F(F(q + v) - F(F(2.0) * x))               # the reference's order
        d = F(np.sqrt(np.maximum(s, F(0.0))))          # distance(), exact
        t = d
        cuts = (F(F(F(t * t) * grow) + floor), _fma(F(t * t), grow, floor))
        assert all(s <= c for c in cuts), (q, v, x)

"""The design of the packed int8 bank kernel
(csrc/scan.cu:packed_bank_wgmma_kernel), held on the CPU.

1. Its branch-free insert, p2 = min(p2, max(p1, p)); p1 = min(p1, p),
   applied to one bucket's packed keys in sub-tile order, gives the plain
   version's two amin passes: the keys are unique within an nt-row tile
   (the low bits carry the sub-tile), with INVALID_PACKED for rows >= n
   (hypothesis).
2. Its split walk: the corpus cut into S splits aligned to nt-row tiles,
   each folded into its own bank, the banks folded in split order with
   _merge_pair2 (bucket_merge), gives int8_packed_bank_plain's keys and rows
   bit for bit, over several S, nt and ragged n; the same walk under
   int8_packed_topk matches the JAX pallas_int8_packed_topk in interpret
   mode.
3. The sources: no file under csrc/ includes tile.cuh or holds mma.sync,
   chip_smoke.py names the new kernel, and the ablation script's pieces are
   where it replaces them.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hnsw_tpu.ops import pallas_scan as jscan
from hnsw_tpu.types import Metric as JMetric

from hnsw_tpu_torch.ops import scan
from tests.conftest import make_unit
from tests.test_torch_scan import (PACKED_TOL, _assert_same_bank_order,
                                   _int8_case, _t)

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "hnsw_tpu_torch" / "csrc"
INVALID = scan.INVALID_PACKED


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Light tests: two threads leave the other cores to the test workers
    that share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. the insert
# ---------------------------------------------------------------------------

def kernel_insert(si):
    """The kernel's insert over the sub-tiles of si [rows, group, buckets],
    in sub-tile order, in int32."""
    p1 = np.full((si.shape[0], si.shape[2]), INVALID, np.int32)
    p2 = p1.copy()
    for gi in range(si.shape[1]):
        p = si[:, gi, :]
        p2 = np.minimum(p2, np.maximum(p1, p))
        p1 = np.minimum(p1, p)
    return p1, p2


@settings(max_examples=40, deadline=None)
@given(group=st.sampled_from([1, 2, 3, 16, 32]),
       seed=st.integers(0, 2 ** 16), invalid_share=st.floats(0.0, 1.0),
       negative=st.booleans())
def test_branch_free_insert_gives_two_amin_passes(group, seed, invalid_share,
                                                  negative):
    rng = np.random.default_rng(seed)
    gbits = max((group - 1).bit_length(), 1)
    gmask = (1 << gbits) - 1
    lo = -(2 ** 31) if negative else 0
    bits = rng.integers(lo, INVALID, (4, group, 8), dtype=np.int64)
    bits[:, :, 0] = bits[:, :1, 0]        # one bucket of equal key bits
    gi = np.arange(group).reshape(1, group, 1)
    si = ((bits & ~gmask) | gi).astype(np.int32)
    si = np.where(rng.random(si.shape) < invalid_share, INVALID, si)
    p1, p2 = kernel_insert(si)
    # the plain version (ops/scan.py:int8_packed_bank_plain)
    t = torch.from_numpy(si)
    b1 = torch.amin(t, dim=1)
    b2 = torch.amin(torch.where(t == b1[:, None, :], INVALID, t), dim=1)
    np.testing.assert_array_equal(p1, b1.numpy())
    np.testing.assert_array_equal(p2, b2.numpy())


# ---------------------------------------------------------------------------
# 2. the split walk
# ---------------------------------------------------------------------------

def split_walk(v8, nvkey, q8, n, *, nt, splits):
    """The kernel's bank: split s walks the nt-row tiles [s * U // S,
    (s + 1) * U // S) of the U = N_pad / nt tiles into its own bank (here the
    plain version over its rows, whose rows are then made global), and the
    split banks are folded in split order with _merge_pair2."""
    units = v8.shape[0] // nt
    out = None
    for s in range(splits):
        r0 = s * units // splits * nt
        r1 = (s + 1) * units // splits * nt
        d, r = scan.int8_packed_bank_plain(v8[r0:r1], nvkey[r0:r1], q8,
                                           n - r0, nt=nt)
        r = torch.where(r >= 0, r + r0, -1)
        if out is None:
            out = (d, r)
            continue
        c = scan.KPAD
        a_d, a_r = out
        n1, ni1, n2, ni2 = scan._merge_pair2(a_d[:, :c], a_r[:, :c],
                                             a_d[:, c:], a_r[:, c:],
                                             d[:, :c], r[:, :c], d[:, c:],
                                             r[:, c:])
        out = (torch.cat([n1, n2], 1), torch.cat([ni1, ni2], 1))
    return out


def _operands(seed, n_pad, d, b):
    rng = np.random.default_rng(seed)
    v8 = torch.from_numpy(rng.integers(-127, 128, (n_pad, d), dtype=np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, (b, d), dtype=np.int8))
    nvkey = torch.from_numpy(-rng.uniform(1e-4, 1e-3, n_pad)
                             .astype(np.float32))
    return v8, nvkey, q8


@pytest.mark.parametrize("splits,nt,n_pad,n", [
    (2, 2048, 8192, 8192),     # the main path's cut: 2 splits of 2 tiles
    (3, 256, 2048, 1900),      # unequal splits, n ragged to 128 and nt
    (8, 128, 1024, 1000),      # group 1: one split per tile
    (4, 512, 4096, 700),       # the last splits hold no live row
    (2, 4096, 8192, 5000),     # gbits 5
    (5, 384, 3840, 3800),      # a group of 3 (gbits 2)
])
def test_split_walk_gives_the_plain_bank(splits, nt, n_pad, n):
    v8, nvkey, q8 = _operands(splits * nt + n, n_pad, 32, 6)
    want_d, want_r = scan.int8_packed_bank_plain(v8, nvkey, q8, n, nt=nt)
    got_d, got_r = split_walk(v8, nvkey, q8, n, nt=nt, splits=splits)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_r, want_r)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_split_walk_matches_pallas(metric, monkeypatch):
    data = make_unit(900, 64, seed=95)
    n, jargs = _int8_case(data, metric, 1024, 64)
    kw = dict(bt=64, nt=256)
    jd, jr = jscan.pallas_int8_packed_topk(*jargs, n, k=256,
                                           metric=JMetric(metric),
                                           interpret=True, **kw)
    monkeypatch.setattr(scan, "int8_packed_bank",
                        lambda v8, nvkey, q8, n, nt: split_walk(
                            v8, nvkey, q8, n, nt=nt, splits=3))
    td, tr = scan.int8_packed_topk(*[_t(a) for a in jargs], n, k=256,
                                   metric=metric, **kw)
    _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, PACKED_TOL)


# ---------------------------------------------------------------------------
# 3. the sources
# ---------------------------------------------------------------------------

def test_no_source_keeps_the_warp_level_mma_loop():
    assert not (CSRC / "tile.cuh").exists()
    for path in sorted(CSRC.iterdir()):
        text = path.read_text()
        assert "tile.cuh" not in text, path.name
        assert "mma.sync" not in text, path.name


def test_chip_smoke_names_the_packed_wgmma_kernel():
    from tests.test_torch_kernel_plan import _kernel_entries
    assert _kernel_entries()["int8_packed_topk"] == (
        "scan.cu", "24packed_bank_wgmma_kernel")
    code = (CSRC / "scan.cu").read_text()
    body = code.split("packed_bank_wgmma_kernel(", 1)[1].split("\nint ", 1)[0]
    # the kernel runs the mainloop of wgmma.cuh
    for piece in ("wg::setup(", "wg::produce(", "wg::consume<int>("):
        assert piece in body, piece


def _ablate_variants():
    spec = importlib.util.spec_from_file_location(
        "packed_ablate", REPO / "scripts" / "packed_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


@pytest.mark.parametrize("variant", sorted(_ablate_variants()))
def test_each_ablation_finds_its_pieces(variant):
    code = (CSRC / "scan.cu").read_text()
    for old, _ in _ablate_variants()[variant]:
        assert code.count(old) == 1, (variant, old)

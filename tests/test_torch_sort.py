"""Port of the bitonic network (hnsw_tpu_torch/ops/sort.py) and of the two
beam merges that needed it, against the JAX package on the CPU.

1. The cases of tests/test_sort.py: keys and payloads exactly equal to the
   JAX outputs, ties included (both networks break ties by lane position).
2. _beam_merge with "bitonic" and "approx" on the inputs of
   test_beam_merge_bitonic_matches_topk: ids, distances and expanded flags
   exactly equal to JAX's ("approx" is exact on both sides off the TPU).
3. hnsw_search_batch with each merge on a JAX-built graph carried across:
   rows equal to JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.models.hnsw import build_hnsw_index as j_build_hnsw_index
from hnsw_tpu.models.hnsw.search import _beam_merge as j_beam_merge
from hnsw_tpu.models.hnsw.search import hnsw_search_batch as j_search
from hnsw_tpu.ops import sort as jsort

from hnsw_tpu_torch import convert
from hnsw_tpu_torch.models.hnsw.search import _beam_merge, hnsw_search_batch
from hnsw_tpu_torch.ops import sort as tsort
from tests.conftest import make_clustered

BIG = 1e30


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# 1. the network
# ---------------------------------------------------------------------------

def _sort_case(length):
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((16, length)).astype(np.float32)
    vals = rng.integers(0, 1 << 20, (16, length)).astype(np.int32)
    return "bitonic_sort_kv", (keys, vals), {}


def _ties_case():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 8, (32, 100)).astype(np.float32)  # many ties
    vals = np.broadcast_to(np.arange(100, dtype=np.int32), (32, 100)).copy()
    return "bitonic_topk", (keys, vals), dict(k=10)


def _presorted_case(na, nb):
    rng = np.random.default_rng(3)
    a = np.sort(rng.standard_normal((8, na)).astype(np.float32), axis=-1)
    a[:, -5:] = BIG                       # empty beam slots
    va = rng.integers(0, 1 << 20, (8, na)).astype(np.int32)
    va[:, -5:] = -1
    b = rng.standard_normal((8, nb)).astype(np.float32)
    vb = rng.integers(0, 1 << 20, (8, nb)).astype(np.int32)
    return "bitonic_topk_presorted", (a, va, b, vb), dict(k=32)


def _merge_case():
    rng = np.random.default_rng(2)
    a = np.sort(rng.standard_normal((4, 64)).astype(np.float32), axis=-1)
    b = np.sort(rng.standard_normal((4, 64)).astype(np.float32), axis=-1)
    return "bitonic_merge_sorted", (a, np.zeros((4, 64), np.int32), b,
                                    np.ones((4, 64), np.int32)), {}


def _tie_heavy_merge_case():
    # runs with repeated keys: which partner keeps a tied key decides the
    # payload order
    rng = np.random.default_rng(4)
    a = np.sort(rng.integers(0, 4, (6, 32)).astype(np.float32), axis=-1)
    b = np.sort(rng.integers(0, 4, (6, 32)).astype(np.float32), axis=-1)
    va = np.broadcast_to(np.arange(32, dtype=np.int32), (6, 32)).copy()
    return "bitonic_merge_sorted", (a, va, b, va + 100), {}


CASES = {
    "sort_8": lambda: _sort_case(8),
    "sort_64": lambda: _sort_case(64),
    "sort_256": lambda: _sort_case(256),
    "topk_non_pow2_ties": _ties_case,
    "presorted_100_128": lambda: _presorted_case(100, 128),
    "presorted_128_128": lambda: _presorted_case(128, 128),
    "presorted_228_96": lambda: _presorted_case(228, 96),
    "merge_sorted_runs": _merge_case,
    "merge_sorted_ties": _tie_heavy_merge_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_network_matches_jax_bit_for_bit(case):
    fn, args, kw = CASES[case]()
    want = getattr(jsort, fn)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tsort, fn)(*(torch.from_numpy(a) for a in args), **kw)
    _same(want, got)
    keys = got[0].numpy()
    assert (np.diff(keys, axis=-1) >= 0).all()


def test_non_pow2_sort_raises():
    vals = torch.zeros(2, 6, dtype=torch.int32)
    with pytest.raises(ValueError):
        tsort.bitonic_sort_kv(torch.zeros(2, 6), vals)


# ---------------------------------------------------------------------------
# 2. the beam merges
# ---------------------------------------------------------------------------

def _merge_inputs(ef, c):
    """The inputs of tests/test_sort.py::test_beam_merge_bitonic_matches_topk
    (unique finite distances, an empty beam tail, masked candidates)."""
    rng = np.random.default_rng(7)
    b = 16
    n_live = ef - 9
    pool = rng.permutation(2 * b * (ef + c)).astype(np.float32)
    beam_d = np.sort(pool[: b * n_live].reshape(b, n_live), axis=-1)
    beam_d = np.concatenate(
        [beam_d, np.full((b, ef - n_live), BIG, np.float32)], axis=-1)
    beam_i = rng.integers(0, 1 << 20, (b, ef)).astype(np.int32)
    beam_i[beam_d >= BIG] = -1
    beam_e = rng.random((b, ef)) < 0.5
    beam_e[beam_d >= BIG] = False
    cand_d = pool[b * n_live: b * n_live + b * c].reshape(b, c).astype(
        np.float32).copy()
    cand_i = rng.integers(0, 1 << 20, (b, c)).astype(np.int32)
    invalid = rng.random((b, c)) < 0.3
    cand_d[invalid] = BIG
    cand_i[invalid] = -1
    return beam_d, beam_i, beam_e, cand_d, cand_i


@pytest.mark.parametrize("merge", ["bitonic", "approx"])
@pytest.mark.parametrize("ef,c", [(64, 96), (100, 128)])
def test_beam_merge_matches_jax(ef, c, merge):
    arrays = _merge_inputs(ef, c)
    want = j_beam_merge(*(jnp.asarray(a) for a in arrays), ef, force=merge)
    got = _beam_merge(*(torch.from_numpy(a) for a in arrays), ef, force=merge)
    _same(want, got)
    # both equal the default stable-sort merge
    _same(want, _beam_merge(*(torch.from_numpy(a) for a in arrays), ef))


# ---------------------------------------------------------------------------
# 3. the search with each merge on a carried-across graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    x = make_clustered(600, 32, k=6, seed=17)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jidx = j_build_hnsw_index(x, M=8)
    tidx = convert.from_reference(x, jidx.to_state(), metric="cosine",
                                  device="cpu")
    rng = np.random.default_rng(9)
    q = x[:48] + 0.05 * rng.standard_normal((48, 32)).astype(np.float32)
    return jidx, tidx, q


@pytest.mark.parametrize("merge", ["sort", "bitonic", "approx"])
def test_search_with_each_merge_matches_jax(carried, merge):
    jidx, tidx, q = carried
    jg, tg = jidx.graph, tidx.graph
    jq = jidx.corpus.pad_queries(q)
    tq = tidx.corpus.pad_queries(q)
    kw = dict(k=10, ef=40, metric="cosine", precision="highest", merge=merge)
    jd, jr = j_search(jidx.corpus.vectors, jidx.corpus.sq_norms, jg.adj0,
                      jg.adj_upper, jnp.full((len(q),), jg.entry, jnp.int32),
                      jq, **kw)
    td, tr = hnsw_search_batch(tidx.corpus.vectors, tidx.corpus.sq_norms,
                               tg.adj0, tg.adj_upper,
                               torch.full((len(q),), tg.entry,
                                          dtype=torch.int32), tq, **kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    assert (tr.numpy() >= 0).all()

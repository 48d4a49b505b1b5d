"""Port of the flat-scan kernels (hnsw_tpu_torch/ops/scan.py).

On the CPU the wrappers run their plain PyTorch versions, which walk the
corpus tile by tile as the JAX Pallas kernels (ops/pallas_scan.py) do: the
bucketed ones keep the same [B, 256] best-two bucket bank, the sweeps the
same running top-k. These tests hold them against pallas_bucket_topk,
pallas_int8_bucket_topk, pallas_int8_packed_topk, pallas_exact_topk and
pallas_int8_topk in interpret mode, with the same tile sizes, on the same
numpy inputs, at the JAX tests' own shapes (tests/test_pallas_scan.py).

Comparing at k = 256 returns the whole bank, sorted. Tolerances: bf16 keys
and distances are f32 sums of exact bf16 products, taken in another order,
so they agree to KEY_TOL; int8 keys and distances multiply an exact int32
dot by f32 scales (same order of operations), so they agree to a few ulps;
packed keys agree within the packed key quantum (PACKED_TOL, the JAX test's
0.05). Rows must be identical wherever a value is not tied with its
neighbour within that tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.ops import pallas_scan as jscan
from hnsw_tpu.types import Corpus as JCorpus
from hnsw_tpu.types import Metric as JMetric

from hnsw_tpu_torch.ops import scan
from tests.conftest import brute_force_knn, make_unit
from tests.torch_support import recall

KEY_TOL = 2e-5
PACKED_TOL = 0.05
METRICS = ["cosine", "euclidean", "dot"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same_bank_order(got_v, got_r, want_v, want_r, tol):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_r, want_r = np.asarray(got_r), np.asarray(want_r)
    np.testing.assert_allclose(got_v, want_v, atol=tol, rtol=1e-6)
    gap = np.abs(np.diff(want_v, axis=1))
    big = np.full((want_v.shape[0], 1), np.inf)
    untied = (np.minimum(np.concatenate([big, gap], 1),
                         np.concatenate([gap, big], 1)) > 2 * tol)
    np.testing.assert_array_equal(got_r[untied], want_r[untied])
    return untied.mean()


def _bf16_case(data, metric, n_pad, nq, pad_rows=None):
    c = JCorpus.from_array(data, metric=metric)
    v = np.zeros((n_pad, c.d_pad), np.float32)
    v[: c.n_pad] = np.asarray(c.vectors)
    if pad_rows is not None:            # rows >= n that would win if seen
        v[c.n: c.n + len(pad_rows), : c.dim] = pad_rows
    vsq = (v * v).sum(1)
    q = np.asarray(c.pad_queries(data[:nq]))
    return c.n, jnp.asarray(v, jnp.bfloat16), vsq, jnp.asarray(q, jnp.bfloat16)


def _port_args(vb, vsq, qb):
    return (_t(vb.astype(jnp.float32)).to(torch.bfloat16), _t(vsq),
            _t(qb.astype(jnp.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("metric", METRICS)
def test_bucket_bank_matches_pallas(metric):
    data = make_unit(1000, 64, seed=81)
    n, vb, vsq, qb = _bf16_case(data, metric, 1024, 128)
    kw = dict(metric=JMetric(metric), bt=128, nt=256, interpret=True)
    args = (vb, jnp.asarray(vsq), qb, n)
    targs = _port_args(vb, vsq, qb)
    for k in (256, 10):
        jd, jr = jscan.pallas_bucket_topk(*args, k=k, **kw)
        td, tr = scan.bucket_topk(*targs, n, k=k, metric=metric, bt=128,
                                  nt=256)
        assert td.shape == (128, k) and tr.dtype == torch.int32
        # euclidean distances are sqrt(key + |q|^2): compare in the key's
        # own (squared) domain, where the sum-order error is additive
        p = 2 if metric == "euclidean" else 1
        frac = _assert_same_bank_order(td.numpy() ** p, tr.numpy(),
                                       np.asarray(jd) ** p, jr, KEY_TOL)
        assert frac > 0.5
    # and the top 10 are the exact top 10 up to bucket collisions
    _, exact = brute_force_knn(data, data[:128], 10, metric)
    assert recall(tr.numpy(), exact) >= 0.98


def test_bucket_rows_beyond_n_are_masked():
    # rows >= n hold copies of the queries: they would rank first if the
    # mask were missing
    data = make_unit(1000, 64, seed=82)
    n, vb, vsq, qb = _bf16_case(data, "cosine", 1024, 16,
                                pad_rows=data[:16])
    jd, jr = jscan.pallas_bucket_topk(vb, jnp.asarray(vsq), qb, n, k=10,
                                      metric=JMetric.COSINE, bt=16, nt=256,
                                      interpret=True)
    td, tr = scan.bucket_topk(*_port_args(vb, vsq, qb), n, k=10,
                              metric="cosine", bt=16, nt=256)
    assert (tr.numpy() < n).all() and (tr.numpy() >= 0).all()
    _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, KEY_TOL)


def test_bucket_k_greater_than_valid_rows():
    data = make_unit(6, 16, seed=83)
    n, vb, vsq, qb = _bf16_case(data, "cosine", 256, 1)
    qb = jnp.tile(qb, (16, 1))
    jd, jr = jscan.pallas_bucket_topk(vb, jnp.asarray(vsq), qb, n, k=10,
                                      metric=JMetric.COSINE, bt=16, nt=256,
                                      interpret=True)
    td, tr = scan.bucket_topk(*_port_args(vb, vsq, qb), n, k=10,
                              metric="cosine", bt=16, nt=256)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:, :6] >= 0).all() and (tr.numpy()[:, 6:] == -1).all()
    assert (td.numpy()[:, 6:] == scan.BIG).all()


def _int8_case(data, metric, n_pad, nq):
    c = JCorpus.from_array(data, metric=metric)
    v = jnp.zeros((n_pad, c.d_pad)).at[: c.n_pad].set(c.vectors)
    vmax = jnp.maximum(jnp.max(jnp.abs(v), axis=1, keepdims=True), 1e-12)
    vscale = vmax / 127.0
    v8 = jnp.clip(jnp.round(v / vscale), -127, 127).astype(jnp.int8)
    vsq = jnp.zeros((n_pad,)).at[: c.n_pad].set(c.sq_norms)
    qf = c.pad_queries(data[:nq])
    qscale = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True),
                         1e-12) / 127.0
    q8 = jnp.clip(jnp.round(qf / qscale), -127, 127).astype(jnp.int8)
    qmeta = jnp.concatenate([qscale, jnp.sum(qf * qf, 1, keepdims=True)], 1)
    return c.n, (v8, vscale[:, 0], vsq, q8, qmeta)


@pytest.mark.parametrize("metric", METRICS)
def test_int8_bucket_bank_matches_pallas(metric):
    data = make_unit(600, 64, seed=87)
    n, jargs = _int8_case(data, metric, 1024, 64)
    targs = [_t(a) for a in jargs]
    for k in (256, 20):
        jd, jr = jscan.pallas_int8_bucket_topk(
            *jargs, n, k=k, metric=JMetric(metric), bt=64, nt=256,
            interpret=True)
        td, tr = scan.int8_bucket_topk(*targs, n, k=k, metric=metric, bt=64,
                                       nt=256)
        live = np.asarray(jd) < scan.BIG
        tol = 1e-6 * max(np.abs(np.asarray(jd)[live]).max(), 1.0)
        _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, tol)
    _, exact = brute_force_knn(data, data[:64], 10, metric)
    assert recall(tr.numpy(), exact) >= 0.98


def test_int8_k_greater_than_valid_rows():
    data = make_unit(6, 16, seed=94)
    n, jargs = _int8_case(data, "cosine", 256, 1)
    jargs = jargs[:3] + (jnp.tile(jargs[3], (64, 1)),
                         jnp.tile(jargs[4], (64, 1)))
    jd, jr = jscan.pallas_int8_bucket_topk(*jargs, n, k=10,
                                           metric=JMetric.COSINE, bt=64,
                                           nt=256, interpret=True)
    td, tr = scan.int8_bucket_topk(*[_t(a) for a in jargs], n, k=10,
                                   metric="cosine", bt=64, nt=256)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:, 6:] == -1).all()


def test_bucket_primitives_match_reference_exactly():
    # the per-tile best-two and the bank merge, on integer keys full of ties
    rng = np.random.default_rng(7)
    bt, g, c = 8, 4, scan.KPAD
    key = rng.integers(0, 6, (bt, g * c)).astype(np.float32)
    rows = np.tile(np.arange(g * c, dtype=np.int32) + 512, (bt, 1))
    want = jscan._bucket_min2(jnp.asarray(key), jnp.asarray(rows), g, c)
    got = scan._bucket_min2(_t(key), _t(rows), g, c)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    a = [np.asarray(x) for x in jscan._bucket_min2(
        jnp.asarray(rng.integers(0, 6, (bt, g * c)).astype(np.float32)),
        jnp.asarray(rows - 512), g, c)]
    want = jscan._merge_pair2(*[jnp.asarray(x) for x in a + list(want)])
    got = scan._merge_pair2(*[_t(x) for x in a], *got)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_shape_contract_and_supported_k():
    assert [scan.supported(k) for k in (0, 1, 32, 33)] == \
        [jscan.supported(k) for k in (0, 1, 32, 33)]
    assert (scan.DEFAULT_BT, scan.DEFAULT_NT, scan.INT8_BT, scan.INT8_NT,
            scan.KPAD) == (jscan.DEFAULT_BT, jscan.DEFAULT_NT, jscan.INT8_BT,
                           jscan.INT8_NT, jscan.KPAD)
    v = torch.zeros((300, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        scan.bucket_topk(v, torch.zeros(300), v[:8], 10, k=5,
                         metric="cosine", bt=8, nt=256)



# ---------------------------------------------------------------------------
# sweep scans (pallas_exact_topk, pallas_int8_topk)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_sweep_matches_pallas(metric):
    data = make_unit(1000, 64, seed=71)
    n, vb, vsq, qb = _bf16_case(data, metric, 1024, 128)
    jd, jr = jscan.pallas_exact_topk(vb, jnp.asarray(vsq), qb, n, k=10,
                                     metric=JMetric(metric), bt=128, nt=256,
                                     interpret=True)
    td, tr = scan.exact_topk_sweep(*_port_args(vb, vsq, qb), n, k=10,
                                   metric=metric, bt=128, nt=256)
    assert td.shape == (128, 10) and tr.dtype == torch.int32
    # euclidean: compared as d^2, where the f32 sum-order error is additive
    p = 2 if metric == "euclidean" else 1
    _assert_same_bank_order(td.numpy() ** p, tr.numpy(), np.asarray(jd) ** p,
                            jr, KEY_TOL)
    _, exact = brute_force_knn(data, data[:128], 10, metric)
    assert recall(tr.numpy(), exact) >= 0.99
    assert (np.diff(td.numpy(), axis=1) >= -1e-6).all()
    assert (tr.numpy() < 1000).all() and (tr.numpy() >= 0).all()


def test_sweep_padding_rows_never_returned():
    # rows >= n hold copies of the queries: they would rank first if the
    # mask were missing
    data = make_unit(100, 32, seed=72)
    n, vb, vsq, qb = _bf16_case(data, "cosine", 256, 4, pad_rows=data[:4])
    qb = jnp.tile(qb, (32, 1))
    jd, jr = jscan.pallas_exact_topk(vb, jnp.asarray(vsq), qb, n, k=5,
                                     metric=JMetric.COSINE, bt=128, nt=128,
                                     interpret=True)
    td, tr = scan.exact_topk_sweep(*_port_args(vb, vsq, qb), n, k=5,
                                   metric="cosine", bt=128, nt=128)
    assert (tr.numpy() < n).all() and (tr.numpy() >= 0).all()
    _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, KEY_TOL)


def test_sweep_k_greater_than_valid_rows():
    data = make_unit(6, 16, seed=73)
    n, vb, vsq, qb = _bf16_case(data, "cosine", 128, 1)
    qb = jnp.tile(qb, (128, 1))
    jd, jr = jscan.pallas_exact_topk(vb, jnp.asarray(vsq), qb, n, k=10,
                                     metric=JMetric.COSINE, bt=128, nt=128,
                                     interpret=True)
    td, tr = scan.exact_topk_sweep(*_port_args(vb, vsq, qb), n, k=10,
                                   metric="cosine", bt=128, nt=128)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:, :6] >= 0).all() and (tr.numpy()[:, 6:] == -1).all()
    assert (td.numpy()[:, 6:] == scan.BIG).all()


def test_sweep_multiple_query_tiles():
    data = make_unit(300, 32, seed=79)
    n, vb, vsq, qb = _bf16_case(data, "cosine", 512, 256)
    jd, jr = jscan.pallas_exact_topk(vb, jnp.asarray(vsq), qb, n, k=5,
                                     metric=JMetric.COSINE, bt=128, nt=256,
                                     interpret=True)
    td, tr = scan.exact_topk_sweep(*_port_args(vb, vsq, qb), n, k=5,
                                   metric="cosine", bt=128, nt=256)
    _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, KEY_TOL)
    # each query's own row is its nearest
    np.testing.assert_array_equal(tr.numpy()[:, 0], np.arange(256))


@pytest.mark.parametrize("metric", METRICS)
def test_int8_sweep_matches_pallas(metric):
    data = make_unit(600, 64, seed=77)
    n, jargs = _int8_case(data, metric, 1024, 128)
    jd, jr = jscan.pallas_int8_topk(*jargs, n, k=20, metric=JMetric(metric),
                                    bt=128, nt=256, interpret=True)
    td, tr = scan.int8_sweep_topk(*[_t(a) for a in jargs], n, k=20,
                                  metric=metric, bt=128, nt=256)
    tol = 1e-6 * max(np.abs(np.asarray(jd)).max(), 1.0)
    _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, tol)
    # the coarse top-20 holds nearly all of the exact top-10
    _, exact = brute_force_knn(data, data[:128], 10, metric)
    assert recall(tr.numpy(), exact) >= 0.98


# ---------------------------------------------------------------------------
# packed int8 scan (pallas_int8_packed_topk)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_int8_packed_matches_pallas(metric):
    data = make_unit(900, 64, seed=93)
    n, jargs = _int8_case(data, metric, 1024, 64)
    targs = [_t(a) for a in jargs]
    kw = dict(bt=64, nt=256)
    for k in (256, 10):
        jd, jr = jscan.pallas_int8_packed_topk(*jargs, n, k=k,
                                               metric=JMetric(metric),
                                               interpret=True, **kw)
        td, tr = scan.int8_packed_topk(*targs, n, k=k, metric=metric, **kw)
        _assert_same_bank_order(td.numpy(), tr.numpy(), jd, jr, PACKED_TOL)
    # the JAX test's own contract: the candidate sets of the payload-carrying
    # bucket kernel, keys within the packed quantum, the exact top-10
    db, rb = jscan.pallas_int8_bucket_topk(*jargs, n, k=10,
                                           metric=JMetric(metric),
                                           interpret=True, **kw)
    for i in range(64):
        assert set(tr.numpy()[i].tolist()) == set(np.asarray(rb)[i].tolist())
    assert np.abs(np.sort(td.numpy(), 1)
                  - np.sort(np.asarray(db), 1)).max() < PACKED_TOL
    _, exact = brute_force_knn(data, data[:64], 10, metric)
    assert recall(tr.numpy(), exact) >= 0.97
    assert (tr.numpy() < 900).all() and (tr.numpy() >= 0).all()


def test_int8_packed_k_greater_than_valid_rows():
    data = make_unit(6, 16, seed=94)
    n, jargs = _int8_case(data, "cosine", 256, 1)
    jargs = jargs[:3] + (jnp.tile(jargs[3], (64, 1)),
                         jnp.tile(jargs[4], (64, 1)))
    jd, jr = jscan.pallas_int8_packed_topk(*jargs, n, k=10,
                                           metric=JMetric.COSINE, bt=64,
                                           nt=256, interpret=True)
    td, tr = scan.int8_packed_topk(*[_t(a) for a in jargs], n, k=10,
                                   metric="cosine", bt=64, nt=256)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:, :6] >= 0).all() and (tr.numpy()[:, 6:] == -1).all()


def test_packed_and_sweep_contracts():
    assert (scan.PACK_BIAS, scan.INVALID_PACKED) == (jscan.PACK_BIAS,
                                                     jscan._INVALID_PACKED)
    v8 = torch.zeros((256, 128), dtype=torch.int8)
    args = (v8, torch.ones(256), torch.ones(256), v8[:64], torch.ones(64, 2),
            10)
    with pytest.raises(ValueError):          # no bias bound for euclidean
        scan.int8_packed_topk(*args, k=5, metric="euclidean", bt=64, nt=256)
    with pytest.raises(ValueError):          # N_pad % nt
        scan.int8_packed_topk(*args, k=5, metric="cosine", bt=64, nt=512)
    v = torch.zeros((300, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # N_pad % nt
        scan.exact_topk_sweep(v, torch.zeros(300), v[:8], 10, k=5,
                              metric="cosine", bt=8, nt=256)
    with pytest.raises(ValueError):          # B % bt
        scan.int8_sweep_topk(*args, k=5, metric="cosine", bt=48, nt=256)

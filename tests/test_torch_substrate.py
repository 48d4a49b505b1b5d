"""Port substrate (hnsw_tpu_torch types, config, distance, top-k, levels,
datagen) held against the JAX package on the same numpy inputs, on the CPU.

Tolerances: the f32 paths differ from the JAX CPU backend only in the order
of f32 sums, so distances agree to 1e-5 absolute on unit-scale data.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hnsw_tpu import config as jconfig
from hnsw_tpu.io.datagen import generate_vectors as j_generate_vectors
from hnsw_tpu.models.hnsw.graph import assign_levels as j_assign_levels
from hnsw_tpu.ops import distance as jdist
from hnsw_tpu.ops import topk as jtopk
from hnsw_tpu.types import Corpus as JCorpus
from hnsw_tpu.types import Metric as JMetric

from hnsw_tpu_torch import config as tconfig
from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models.hnsw.graph import assign_levels
from hnsw_tpu_torch.ops import distance as tdist
from hnsw_tpu_torch.ops import topk as ttopk
from hnsw_tpu_torch.types import Corpus, Metric

METRICS = ["cosine", "euclidean", "dot"]
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_corpus_layout_matches_reference():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((37, 70)).astype(np.float32)
    ids = [f"v{i}" for i in range(37)]
    jc = JCorpus.from_array(data, metric="l2", ids=ids)
    tc = Corpus.from_array(data, metric="l2", ids=ids, device="cpu")
    assert (tc.n, tc.dim, tc.n_pad, tc.d_pad) == (jc.n, jc.dim, jc.n_pad,
                                                  jc.d_pad) == (37, 70, 40, 128)
    assert tc.metric == Metric.EUCLIDEAN and tc.vectors.dtype == torch.float32
    np.testing.assert_array_equal(tc.vectors.numpy(), np.asarray(jc.vectors))
    np.testing.assert_allclose(tc.sq_norms.numpy(), np.asarray(jc.sq_norms),
                               rtol=1e-6)
    rows = np.array([[0, 36, -1, 39]])
    np.testing.assert_array_equal(tc.row_ids_to_external(rows),
                                  jc.row_ids_to_external(rows))
    # numpy and tensor queries pad to the same [B, D_pad] f32
    q = data[:3]
    want = np.asarray(jc.pad_queries(q))
    np.testing.assert_array_equal(tc.pad_queries(q).numpy(), want)
    np.testing.assert_array_equal(tc.pad_queries(_t(q)).numpy(), want)
    np.testing.assert_array_equal(tc.pad_queries(q[0]).numpy(), want[:1])
    with pytest.raises(ValueError):
        tc.pad_queries(np.zeros((2, 5), np.float32))


def test_config_tables_are_a_copy():
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    for name in ("HNSW_EF", "IVF_FLAT_PROBES", "IVF_HNSW_MODES", "LSH_MODES",
                 "PCAF_KFILTER", "LIGHTNING_PERCENT"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert {m.value: v for m, v in t.items()} == \
            {m.value: v for m, v in j.items()}, name
    for mode in ("turbo", "fast", "balanced", "accurate", "precise"):
        for k in (1, 10, 400):
            assert tconfig.ef_for(mode, k) == jconfig.ef_for(mode, k)
            assert tconfig.ef_for(mode, k, "ivf_hnsw") == \
                jconfig.ef_for(mode, k, "ivf_hnsw")


@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_reference(metric):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((9, 128)).astype(np.float32)
    v = rng.standard_normal((50, 128)).astype(np.float32)
    vsq = (v * v).sum(1)
    jm, tm = JMetric(metric), Metric(metric)
    for prec in ("f32", "bf16"):
        want = jdist.score_block(jnp.asarray(a), jnp.asarray(v),
                                 jnp.asarray(vsq), metric=jm, precision=prec)
        got = tdist.score_block(_t(a), _t(v), _t(vsq), metric=tm,
                                precision=prec)
        # bf16 products are exact in f32 on both sides: same tolerance
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-5)
    rows = rng.integers(0, 50, (9, 7)).astype(np.int32)
    valid = rng.random((9, 7)) < 0.7
    want = jdist.gather_score(jnp.asarray(a), jnp.asarray(rows),
                              jnp.asarray(v), jnp.asarray(vsq), metric=jm,
                              valid=jnp.asarray(valid))
    got = tdist.gather_score(_t(a), _t(rows), _t(v), _t(vsq), metric=tm,
                             valid=_t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    assert (got.numpy()[~valid] == tdist.BIG).all()
    want = jdist.pairwise_distances(jnp.asarray(a), jnp.asarray(v), metric=jm)
    got = tdist.pairwise_distances(_t(a), _t(v), metric=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def test_normalize_and_unit_distances():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 64)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(tdist.normalize(_t(x)).numpy(),
                               np.asarray(jdist.normalize(jnp.asarray(x))),
                               atol=ATOL)
    u = x[:10] / np.maximum(np.linalg.norm(x[:10], axis=1, keepdims=True),
                            1e-6)
    dots = u @ u.T
    sq = (u * u).sum(1)
    for m in METRICS:
        want = jdist.distances_from_dots(jnp.asarray(dots), jnp.asarray(sq),
                                         jnp.asarray(sq), JMetric(m))
        got = tdist.distances_from_dots(_t(dots), _t(sq), _t(sq), Metric(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_top_k_tie_order_matches_lax_top_k():
    # integer-valued distances: many exact ties, which lax.top_k returns
    # lower index first and torch.topk does not promise to
    rng = np.random.default_rng(4)
    d = rng.integers(0, 5, (16, 40)).astype(np.float32)
    for k in (1, 7, 40):
        jd, ji = jtopk.top_k_ascending(jnp.asarray(d), k)
        td, ti = ttopk.top_k_ascending(_t(d), k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ids_a = rng.integers(0, 30, (16, 8)).astype(np.int32)
    ids_b = rng.integers(0, 30, (16, 8)).astype(np.int32)
    da, db = np.sort(d[:, :8], 1), np.sort(d[:, 8:16], 1)
    jd, ji = jtopk.merge_topk(jnp.asarray(da), jnp.asarray(ids_a),
                              jnp.asarray(db), jnp.asarray(ids_b), 8)
    td, ti = ttopk.merge_topk(_t(da), _t(ids_a), _t(db), _t(ids_b), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ids = np.concatenate([ids_a, ids_a[:, :4]], 1)
    dd = np.sort(d[:, :12], 1)
    jd, ji = jtopk.dedupe_ascending(jnp.asarray(dd), jnp.asarray(ids), 6)
    td, ti = ttopk.dedupe_ascending(_t(dd), _t(ids), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 42), (31173, 7)])
def test_assign_levels_identical(n, seed):
    ml = tconfig.DEFAULTS["ml"]
    np.testing.assert_array_equal(assign_levels(n, ml, seed, max_cap=14),
                                  j_assign_levels(n, ml, seed, max_cap=14))


def test_generate_vectors_identical():
    for dist in ("embedding", "gaussian", "clustered"):
        np.testing.assert_array_equal(
            generate_vectors(300, 96, distribution=dist, num_clusters=8,
                             seed=5),
            j_generate_vectors(300, 96, distribution=dist, num_clusters=8,
                               seed=5))


def test_metric_coerce_aliases():
    for alias, want in (("l2", "euclidean"), (":cosine", "cosine"),
                        ("ip", "dot"), ("inner_product", "dot")):
        assert Metric.coerce(alias).value == JMetric.coerce(alias).value \
            == want


def test_jax_runs_on_cpu_here():
    # the comparisons above are against the JAX CPU backend
    assert jax.default_backend() == "cpu"

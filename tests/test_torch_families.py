"""Port of k-means, partitioned HNSW, IVF-HNSW and the bench harness
(hnsw_tpu_torch/ops/kmeans.py, models/partitioned.py, models/ivf_hnsw.py,
bench/harness.py) against the JAX package, on the CPU.

1. k-means: identical sampled_pp_init picks (the same seeded numpy draws),
   identical balanced_assign, spill_assign and random_partition (copied
   numpy), lloyd centroids within 1e-4 (f32 sums taken in another order)
   with identical assignments, identical topc_clusters rows.
2. probe_mask_from_centroids and sample_entries_grouped: identical rows.
3. build_layers_stacked on the same member sets: identical adjacency on the
   host path (the same numpy code); on the device path, at both
   precisions, a mean row-set overlap >= 0.98, as tests/test_torch_hnsw.py
   holds build_graph, because f32 sums taken in another order swap
   near-tied candidates, and the heuristic then selects differently.
4. Both families built by the JAX package and carried across
   (convert.from_reference) return identical rows at every mode, with
   distances within 1e-5 (both re-rank in f32).
5. Port-built indexes clear tests/test_families.py's bars on its data
   (precise recall 0.85 partitioned, 0.75 IVF-HNSW), build the same graphs
   as the JAX package, and an empty partition never seeds the beam.
6. Cross-package .npz persistence, both ways, for both families.
7. The harness: the reference's return keys, its latency table, and a
   search that raises makes run_search_benchmark raise (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hnsw_tpu
from hnsw_tpu.bench import harness as jharness
from hnsw_tpu.models import IVFHNSWIndex as JIVFHNSWIndex
from hnsw_tpu.models import build_ivf_hnsw_index as j_build_ivf_hnsw
from hnsw_tpu.models import build_partitioned_hnsw as j_build_partitioned
from hnsw_tpu.models._partition_scan import \
    probe_mask_from_centroids as j_probe_mask
from hnsw_tpu.models.hnsw.build import build_layers_stacked as j_stacked
from hnsw_tpu.models.hnsw.search import \
    sample_entries_grouped as j_sample_grouped
from hnsw_tpu.ops import kmeans as jk
from hnsw_tpu.types import Corpus as JCorpus
from hnsw_tpu.types import Metric as JMetric

import hnsw_tpu_torch as ht
from hnsw_tpu_torch import convert
from hnsw_tpu_torch.bench import harness
from hnsw_tpu_torch.models._partition_scan import probe_mask_from_centroids
from hnsw_tpu_torch.models.hnsw.build import build_layers_stacked
from hnsw_tpu_torch.models.hnsw.search import sample_entries_grouped
from hnsw_tpu_torch.ops import kmeans as tk
from hnsw_tpu_torch.types import Corpus, Metric
from tests.conftest import brute_force_knn, make_clustered, recall_at_k

CPU = dict(device="cpu")
MODES = ("turbo", "fast", "balanced", "accurate", "precise")

# tests/test_families.py's data, queries and bars
DATA = make_clustered(1200, 64, k=10, seed=21)
QUERIES = DATA[:24]
_, EXACT10 = brute_force_knn(DATA, QUERIES, 10, "cosine")
CASES = {
    "partitioned_hnsw": (dict(num_partitions=4), 0.85),
    "ivf_hnsw": (dict(num_partitions=8), 0.75),
}
J_BUILD = {"partitioned_hnsw": j_build_partitioned,
           "ivf_hnsw": j_build_ivf_hnsw}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The port's builds here are many small CPU operators: on two threads
    they run as fast as on every core, and leave the other cores to the
    test workers that share the host (a timing test among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    data = make_clustered(600, 48, k=6, seed=3)
    return data, JCorpus.from_array(data), Corpus.from_array(data, **CPU)


# ---------------------------------------------------------------------------
# 1. k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_sampled_pp_init_picks_the_same_rows(corpora, metric):
    data, jc, tc = corpora
    want = np.asarray(jk.sampled_pp_init(jc.vectors, jc.n, k=7, seed=5,
                                         metric=JMetric(metric), sample=256))
    got = tk.sampled_pp_init(tc.vectors, tc.n, k=7, seed=5, metric=metric,
                             sample=256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_lloyd_and_train_kmeans_match(corpora, metric):
    data, jc, tc = corpora
    init = data[::75][:8]
    init = np.pad(init, ((0, 0), (0, jc.d_pad - data.shape[1])))
    valid_j = jnp.arange(jc.n_pad) < jc.n
    jc_c, ja = jk.lloyd(jc.vectors, jc.sq_norms, valid_j, jnp.asarray(init),
                        iters=6, metric=JMetric(metric))
    valid_t = torch.arange(tc.n_pad) < tc.n
    tc_c, ta = tk.lloyd(tc.vectors, tc.sq_norms, valid_t,
                        torch.from_numpy(init), iters=6, metric=metric)
    np.testing.assert_allclose(tc_c.numpy(), np.asarray(jc_c), atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    jc_c, ja = jk.train_kmeans(jc.vectors, jc.sq_norms, jc.n, k=6, seed=9,
                               metric=JMetric(metric))
    tc_c, ta = tk.train_kmeans(tc.vectors, tc.sq_norms, tc.n, k=6, seed=9,
                               metric=metric)
    np.testing.assert_allclose(tc_c.numpy(), np.asarray(jc_c), atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_topc_and_host_assignments_match(corpora):
    data, jc, tc = corpora
    cents, _ = tk.train_kmeans(tc.vectors, tc.sq_norms, tc.n, k=9, seed=2)
    jd, ji = jk.topc_clusters(jc.vectors, jc.sq_norms, jc.n,
                              jnp.asarray(cents.numpy()), c=4, chunk=256)
    td, ti = tk.topc_clusters(tc.vectors, tc.sq_norms, tc.n, cents, c=4,
                              chunk=256)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-5)

    for cap in (60, 80, 200):
        prim = tk.balanced_assign(td, ti, 9, cap)
        np.testing.assert_array_equal(prim, jk.balanced_assign(td, ti, 9, cap))
        np.testing.assert_array_equal(
            tk.spill_assign(prim, td, ti, 9, cap),
            jk.spill_assign(prim, td, ti, 9, cap))
    for shuffle in (True, False):
        np.testing.assert_array_equal(
            tk.random_partition(600, 7, seed=4, shuffle=shuffle),
            jk.random_partition(600, 7, seed=4, shuffle=shuffle))


def test_device_pp_init_picks_distinct_rows(corpora):
    """kmeans_pp_init draws from a torch.Generator, so its picks differ from
    jax.random's; it must still pick k distinct valid rows."""
    _, _, tc = corpora
    valid = torch.arange(tc.n_pad) < tc.n
    cents = tk.kmeans_pp_init(tc.vectors, tc.sq_norms, valid, 3, k=10,
                              metric=Metric.COSINE)
    eq = (cents[:, None, :] == tc.vectors[None, : tc.n, :]).all(-1)
    rows = eq.int().argmax(dim=1)
    assert bool(eq.any(dim=1).all()) and len(set(rows.tolist())) == 10
    c2, assign = tk.train_kmeans(tc.vectors, tc.sq_norms, tc.n, k=10,
                                 init="device_pp")
    assert c2.shape == (10, tc.d_pad) and int(assign.min()) >= 0


# ---------------------------------------------------------------------------
# 2. probes and grouped entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_probe_mask_and_grouped_entries_match(corpora, metric):
    data, jc, tc = corpora
    rng = np.random.default_rng(7)
    q = np.pad(data[:40] + 0.05 * rng.standard_normal((40, 48)),
               ((0, 0), (0, jc.d_pad - 48))).astype(np.float32)
    cents = q[::4][:9] + 0.1
    jm, jp = j_probe_mask(jnp.asarray(q), jnp.asarray(cents), num_probes=3,
                          metric=JMetric(metric))
    tm, tp = probe_mask_from_centroids(torch.from_numpy(q),
                                       torch.from_numpy(cents), num_probes=3,
                                       metric=metric)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    samples = rng.permutation(600)[:5 * 16].reshape(5, 16).astype(np.int32)
    samples[2, 10:] = -1
    samples[4, :] = -1
    for r in (1, 3):
        want = j_sample_grouped(jc.vectors, jc.sq_norms,
                                jnp.asarray(samples), jnp.asarray(q),
                                metric=JMetric(metric), r=r)
        got = sample_entries_grouped(tc.vectors, tc.sq_norms,
                                     torch.from_numpy(samples),
                                     torch.from_numpy(q), metric=metric, r=r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# 3. stacked layer builds
# ---------------------------------------------------------------------------

def _overlap(a, b):
    ov = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
          / max(len(set(y[y >= 0].tolist())), 1) for x, y in zip(a, b)]
    return float(np.mean(ov))


@pytest.mark.parametrize("path,precision", [("host", "highest"),
                                            ("device", "highest"),
                                            ("device", "bf16")])
def test_build_layers_stacked_matches(corpora, path, precision):
    data, jc, tc = corpora
    order = np.random.default_rng(11).permutation(600).astype(np.int32)
    sizes = (300, 200, 1, 99) if path == "host" else (560, 40)
    members, s = [], 0
    for size in sizes:
        members.append(np.sort(order[s:s + size]))
        s += size
    kw = dict(cap=16, k_cand=32, precision=precision)
    want = j_stacked(jc.vectors, members, metric=JMetric("cosine"), **kw)
    got = build_layers_stacked(tc.vectors, members, metric="cosine", **kw)
    assert [g.shape for g in got] == [np.asarray(w).shape for w in want]
    for g, w in zip(got, want):
        if path == "host":
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            assert _overlap(g, np.asarray(w)) >= 0.98


# ---------------------------------------------------------------------------
# 4-5. the families
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    """family -> (JAX-built, the same graph carried across, port-built)."""
    out = {}
    for fam, (kw, _) in CASES.items():
        j = J_BUILD[fam](DATA, metric="cosine", **kw)
        carried = convert.from_reference(DATA, j.to_state(), metric="cosine",
                                         family=fam, **CPU)
        out[fam] = (j, carried, ht.build_index(DATA, fam, metric="cosine",
                                               **kw, **CPU))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fam", list(CASES))
def test_identical_graph_identical_rows(built, fam, mode):
    j, t, _ = built[fam]
    jd, jr = j.search_batch(QUERIES, 10, mode)
    td, tr = t.search_batch(QUERIES, 10, mode)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


@pytest.mark.parametrize("fam", list(CASES))
def test_port_built_clears_the_family_bars(built, fam):
    j, _, t = built[fam]
    _, rows = t.search_batch(QUERIES, 10, mode="precise")
    assert recall_at_k(rows.numpy(), EXACT10) >= CASES[fam][1]
    # the same seeded build: the same graph as the JAX package
    for name, arr in j.to_state()["arrays"].items():
        if name == "centroids":
            np.testing.assert_allclose(t.to_state()["arrays"][name],
                                       np.asarray(arr), atol=1e-4)
        else:
            np.testing.assert_array_equal(t.to_state()["arrays"][name],
                                          np.asarray(arr))
    assert t.to_state()["params"] == j.to_state()["params"]
    info = ht.index_info(t)
    assert (info["type"], info["num_vectors"], info["dimensions"]) == \
        (fam, 1200, 64)
    assert info == j.index_info()


def test_partitioned_empty_partitions_never_return_padding():
    """n < num_partitions leaves empty partitions; their entry stays -1, so
    the beam never seeds on a padding row and no padding result reaches
    the merge."""
    small = DATA[:10]
    idx = ht.build_partitioned_hnsw(small, num_partitions=8, M=4, **CPU)
    assert (idx.entries_p.numpy() == -1).sum() == 8 - 5
    d, r = idx.search_batch(small[:3], 5, mode="precise")
    r, d = r.numpy(), d.numpy()
    assert (r[:, 0] == np.arange(3)).all()          # self found first
    assert (r >= 0).all(), r                         # k=5 <= n=10: all real
    assert (d[r >= 0] < 0.999).all()                 # no padding distance 1.0


def test_ivf_hnsw_legacy_state_and_search_percent(built):
    """A state without "expand" loads with the legacy expand 4, as in the
    reference; search_percent maps to a probe count the same way."""
    j, t, _ = built["ivf_hnsw"]
    state = j.to_state()
    del state["params"]["expand"]
    old_j = JIVFHNSWIndex.from_state(j.corpus, state)
    old_t = ht.IVFHNSWIndex.from_state(t.corpus, state)
    assert old_j.expand == old_t.expand == 4
    _, jr = old_j.search_batch(QUERIES, 10, search_percent=0.25)
    _, tr = old_t.search_batch(QUERIES, 10, search_percent=0.25)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# 6. cross-package persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(CASES))
def test_npz_persistence_both_ways(tmp_path, built, fam):
    j, _, t = built[fam]
    q = DATA[100:140]
    pj = hnsw_tpu.save_index(j, str(tmp_path / "jax"))
    from_j = ht.load_index(pj, **CPU)
    pt = ht.save_index(t, str(tmp_path / "port"))
    from_t = hnsw_tpu.load_index(pt)
    for a, b in ((from_j, j), (from_t, t)):
        assert type(a).__name__ == type(b).__name__
        assert a.to_state()["params"] == b.to_state()["params"]
        _, ra = a.search_batch(q, 10, "balanced")
        _, rb = b.search_batch(q, 10, "balanced")
        np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))


# ---------------------------------------------------------------------------
# 7. the harness
# ---------------------------------------------------------------------------

def test_latency_report_matches():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 100):
        s = rng.exponential(3.0, n)
        assert harness.latency_report(s) == jharness.latency_report(s)


def test_harness_keys_match(built):
    j, _, t = built["partitioned_hnsw"]
    kw = dict(k=10, batch_size=16, warmup=1, iters=2, single_query_iters=2)
    want = jharness.run_search_benchmark(j, DATA[:16], **kw)
    got = harness.run_search_benchmark(t, DATA[:16], **kw)
    assert set(got) == set(want)
    assert (got["batch_size"], got["k"], got["mode"]) == \
        (want["batch_size"], want["k"], want["mode"])
    assert got["qps_device"] > 0 and got["qps_batched"] > 0
    rk = dict(k=10, mode="precise", num_queries=50)
    want = jharness.run_recall_benchmark(j, DATA, **rk)
    got = harness.run_recall_benchmark(t, DATA, **rk)
    assert got == want
    idx, secs = harness.measure_build(
        lambda: ht.build_index(DATA[:200], "ivf_hnsw", num_partitions=2,
                               **CPU))
    assert idx.corpus.n == 200 and secs > 0
    assert harness.warmup(idx) is idx
    idx2, used = harness.build_with_timeout(
        lambda: ht.build_index(DATA[:50], "flat", **CPU), 60.0)
    assert idx2.corpus.n == 50 and not used


def test_a_failing_search_makes_the_benchmark_raise(built):
    """Deliberate divergence (ROADMAP §C): the reference wraps its device
    QPS measurement in `except Exception` and drops the error, so a search
    that fails there reports no qps_device; the port lets it propagate."""

    class Failing:
        """An index whose searches fail after the warm-up and the batched
        loop (4 calls), i.e. in the device-QPS measurement."""
        qps_scan_safe = False

        def __init__(self, index):
            self.index, self.corpus, self.calls = index, index.corpus, 0

        def search_batch(self, q, k, mode=None):
            self.calls += 1
            if self.calls > 4:
                raise RuntimeError("search failed")
            return self.index.search_batch(q, k, mode)

    j, _, t = built["ivf_hnsw"]
    kw = dict(batch_size=8, warmup=1, iters=2, single_query_iters=0)
    with pytest.raises(RuntimeError, match="search failed"):
        harness.run_search_benchmark(Failing(t), DATA[:8], **kw)
    rep = jharness.run_search_benchmark(Failing(j), DATA[:8], **kw)
    assert "qps_device" not in rep and rep["qps_batched"] > 0

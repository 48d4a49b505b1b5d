"""Port of the bucketed large-N builder (hnsw_tpu_torch/models/hnsw/
build_large.py) against the JAX package, on the CPU.

The port's _reverse_device keeps every reverse-edge group start where the
reference's binary search over the unsorted -1 tail loses some (ROADMAP §C,
tests/test_torch_hnsw.py::test_reverse_edges_keep_every_group_start). The
builder symmetrizes through it, so on a layer with padding rows the two
graphs differ by those edges. Each parity test therefore runs the port with
the reference's reverse-edge collection substituted (fixture
`reference_reverse`): every other step is held to the JAX rows. The port's
own graph is held to the reference tests' quality bars and to the JAX
graph's quality.

1. The bucketed build at 1,500 x 48, cluster_size 256, 2 probes
   (tests/test_hnsw.py:160-186): mean adjacency row-set overlap with JAX's
   >= 0.98 at "highest" and >= 0.95 at "bf16"; with its own reverse edges
   the port's search recall >= 0.9 and its edge recall no worse than JAX's.
   Each case runs under cosine on unit rows and under euclidean on the same
   rows scaled to norms in [0.5, 2], so that the euclidean neighbours are
   not the cosine ones (the route of sift-128-euclidean past LARGE_N).
2. Refinement on the 4,096 x 64 embedding corpus (tests/test_hnsw.py:
   188-220): refined edge recall >= 0.99 and >= the unrefined one, and the
   overlap with JAX's refined graph.
3. A shuffled subset as member_rows (the gather path) builds JAX's graph.
4. Byte budgets cut rows, never change them.
5. build_graph past a lowered LARGE_N in both packages (cosine and
   euclidean), the JAX graph carried across answering with JAX's rows, and
   build_hnsw_index passing the large-N options on.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.io.datagen import generate_vectors
from hnsw_tpu.models.hnsw import HNSWIndex as JHNSWIndex
from hnsw_tpu.models.hnsw import build as jbuild
from hnsw_tpu.models.hnsw import build_large as jlarge
from hnsw_tpu.types import Corpus as JCorpus

from hnsw_tpu_torch import convert
from hnsw_tpu_torch.models.hnsw import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.hnsw import build_large as tlarge
from hnsw_tpu_torch.models.hnsw.build import build_graph
from hnsw_tpu_torch.models.hnsw.graph import HNSWGraph
from hnsw_tpu_torch.types import Corpus
from tests.conftest import brute_force_knn, make_unit
from tests.torch_support import recall

BUCKET = dict(cap=32, k_cand=48, metric="cosine", cluster_size=256,
              n_probe_clusters=2)
REFINE = dict(cap=32, k_cand=48, metric="cosine", cluster_size=512,
              n_probe_clusters=4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_reverse(monkeypatch):
    """The port's builder with the reference's _reverse_device."""
    def reverse(fwd, fwd_d, rev_cap):
        rev, rev_d = jbuild._reverse_device(jnp.asarray(fwd.numpy()),
                                            jnp.asarray(fwd_d.numpy()),
                                            rev_cap)
        return (torch.from_numpy(np.array(rev)),
                torch.from_numpy(np.array(rev_d)))
    monkeypatch.setattr(tlarge, "_reverse_device", reverse)


def _overlap(a, b):
    scores = []
    for x, y in zip(a, b):
        sx, sy = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        scores.append(len(sx & sy) / max(len(sx | sy), 1))
    return float(np.mean(scores))


def _edge_recall(adj, data, k=10, metric="cosine"):
    """Mean share of each row's exact k nearest (by the metric, float64)
    among its adjacency."""
    x = data.astype(np.float64)
    if metric == "cosine":
        xs = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        dist = -(xs @ xs.T)
    else:
        sq = (x * x).sum(1)
        dist = sq[:, None] + sq[None, :] - 2 * x @ x.T
    np.fill_diagonal(dist, np.inf)
    truth = np.argsort(dist, axis=1)[:, :k]
    return float(np.mean([len(set(a[a >= 0]) & set(t)) / k
                          for a, t in zip(adj, truth)]))


def _corpora(data, metric="cosine"):
    return (JCorpus.from_array(data, metric=metric),
            Corpus.from_array(data, metric=metric, device="cpu"))


def _both(data, rows=None, **kw):
    """The JAX and the port's build_layer_clustered on the same rows."""
    jc, tc = _corpora(data, kw.get("metric", "cosine"))
    rows = np.arange(len(data), dtype=np.int32) if rows is None else rows
    ja = jlarge.build_layer_clustered(jc.vectors, jc.sq_norms, rows, **kw)
    ta = tlarge.build_layer_clustered(tc.vectors, tc.sq_norms, rows, **kw)
    assert ta.shape == ja.shape and ta.dtype == np.int32
    return ja, ta


BUCKET_DATA = make_unit(1500, 48, seed=95)
# the same rows at norms in [0.5, 2]: their euclidean neighbours are not
# their cosine ones
SCALED_DATA = BUCKET_DATA * np.random.default_rng(97).uniform(
    0.5, 2.0, (1500, 1)).astype(np.float32)
DATA = {"cosine": BUCKET_DATA, "euclidean": SCALED_DATA}


def test_scaled_rows_have_other_euclidean_neighbours():
    cos = _edge_recall(np.argsort(-(BUCKET_DATA @ BUCKET_DATA.T), axis=1)
                       [:, 1:11], SCALED_DATA, metric="euclidean")
    assert cos < 0.5, cos


# ---------------------------------------------------------------------------
# 1. the bucketed build
# ---------------------------------------------------------------------------

# the cosine cases keep the ids they had before their euclidean twins
@pytest.mark.parametrize("metric,precision,bar", [
    pytest.param("cosine", "highest", 0.98, id="highest-0.98"),
    pytest.param("cosine", "bf16", 0.95, id="bf16-0.95"),
    pytest.param("euclidean", "highest", 0.98, id="euclidean-highest-0.98"),
    pytest.param("euclidean", "bf16", 0.95, id="euclidean-bf16-0.95"),
])
def test_bucketed_build_matches_jax(reference_reverse, metric, precision,
                                    bar):
    ja, ta = _both(DATA[metric], precision=precision,
                   **dict(BUCKET, metric=metric))
    ov = _overlap(ta, ja)
    assert ov >= bar, ov


@pytest.mark.parametrize("metric,precision", [
    pytest.param("cosine", "highest", id="highest"),
    pytest.param("cosine", "bf16", id="bf16"),
    pytest.param("euclidean", "highest", id="euclidean-highest"),
    pytest.param("euclidean", "bf16", id="euclidean-bf16"),
])
def test_bucketed_build_quality(metric, precision):
    data = DATA[metric]
    ja, ta = _both(data, precision=precision, **dict(BUCKET, metric=metric))
    c = Corpus.from_array(data, metric=metric, device="cpu")

    def search_recall(adj, q, ef):
        adj0 = np.full((c.n_pad, 32), -1, np.int32)
        adj0[: c.n] = adj
        g = HNSWGraph(levels=torch.zeros(c.n_pad, dtype=torch.int32),
                      adj0=torch.from_numpy(adj0),
                      adj_upper=torch.zeros((0, c.n_pad, 16),
                                            dtype=torch.int32),
                      entry=0, max_level=0, m=16, m0=32, ef_construction=200,
                      n=c.n)
        _, exact = brute_force_knn(data, q, 10, metric)
        _, rows = HNSWIndex(c, g).search_batch(q, 10, ef=ef)
        return recall(rows.numpy(), exact)

    # the port keeps reverse edges the reference loses (with the reference's
    # reverse edges the two graphs are one: test_bucketed_build_matches_jax).
    # Under cosine that graph has no fewer exact 10-NN edges. Under euclidean
    # at norms in [0.5, 2] the kept reverse edges take about 0.007 of them
    # (0.9745 against 0.9817 at "highest"): the bar there is 0.01 below the
    # reference's, and the search below holds the graph no worse.
    slack = 0.0 if metric == "cosine" else 0.01
    assert _edge_recall(ta, data, metric=metric) >= \
        _edge_recall(ja, data, metric=metric) - slack
    assert search_recall(ta, data[:32], 150) >= 0.9
    # off-corpus queries at a short beam, where a graph's gaps show: no worse
    # than the reference's graph
    rng = np.random.default_rng(1)
    q = data[:256] + (0.3 / np.sqrt(48)) * np.linalg.norm(
        data[:256], axis=1, keepdims=True) * rng.standard_normal(
        (256, 48)).astype(np.float32)
    assert search_recall(ta, q, 20) >= search_recall(ja, q, 20)


# ---------------------------------------------------------------------------
# 2. refinement
# ---------------------------------------------------------------------------

EMBED = generate_vectors(4096, 64, distribution="embedding", num_clusters=32,
                         seed=5)


def test_refinement_quality_and_parity(reference_reverse):
    _, base = _both(EMBED, refine_rounds=0, **REFINE)
    ja, ta = _both(EMBED, refine_rounds=2, **REFINE)
    refined = _edge_recall(ta, EMBED)
    assert refined >= 0.99 and refined >= _edge_recall(base, EMBED), refined
    assert _overlap(ta, ja) >= 0.98


# ---------------------------------------------------------------------------
# 3. member rows that are not the identity
# ---------------------------------------------------------------------------

def test_shuffled_member_rows_build_the_jax_graph(reference_reverse):
    data = make_unit(2000, 48, seed=96)
    rows = np.random.default_rng(3).permutation(2000)[:1300].astype(np.int32)
    assert rows[0] != 0
    ja, ta = _both(data, rows=rows, precision="highest", **BUCKET)
    assert _overlap(ta, ja) >= 0.98
    # ids are global rows of the subset
    assert set(ta[ta >= 0].tolist()) <= set(rows.tolist())


# ---------------------------------------------------------------------------
# 4. budgets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,budget", [
    ("CELL_BUDGET_BYTES", 1 << 20),             # ~10 member rows a chunk
    ("REFINE_BUDGET_BYTES", 5 * 6 * 1056 * 128),  # 5 rows of the gather
])
def test_budgets_do_not_change_rows(monkeypatch, name, budget):
    c = Corpus.from_array(BUCKET_DATA, device="cpu")
    rows = np.arange(c.n, dtype=np.int32)
    kw = dict(BUCKET, precision="highest")
    whole = tlarge.build_layer_clustered(c.vectors, c.sq_norms, rows, **kw)
    monkeypatch.setattr(tlarge, name, budget)
    calls = []
    real = torch.einsum if name == "REFINE_BUDGET_BYTES" else torch.matmul
    spy = (lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(torch, "einsum" if name == "REFINE_BUDGET_BYTES"
                        else "matmul", spy)
    cut = tlarge.build_layer_clustered(c.vectors, c.sq_norms, rows, **kw)
    monkeypatch.undo()
    np.testing.assert_array_equal(cut, whole)
    # the small budget really cut the work into more pieces
    assert len(calls) > 100


# ---------------------------------------------------------------------------
# 5. build_graph and build_hnsw_index past LARGE_N
# ---------------------------------------------------------------------------

@pytest.fixture
def low_large_n(monkeypatch):
    monkeypatch.setattr(jlarge, "LARGE_N", 1000)
    monkeypatch.setattr(tlarge, "LARGE_N", 1000)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_build_graph_past_large_n(low_large_n, reference_reverse, metric):
    data = DATA[metric]
    jc, tc = _corpora(data, metric)
    jg = jbuild.build_graph(jc, m=16, build_precision="highest")
    tg = build_graph(tc, m=16, build_precision="highest")
    np.testing.assert_array_equal(tg.levels.numpy(), np.asarray(jg.levels))
    assert (tg.max_level, tg.entry, tg.m0) == (jg.max_level, jg.entry, jg.m0)
    ov = _overlap(tg.adj0.numpy()[: tc.n], np.asarray(jg.adj0)[: jc.n])
    assert ov >= 0.98, ov
    # the JAX graph carried across answers with JAX's rows
    jidx = JHNSWIndex(jc, jg)
    tidx = convert.from_reference(data, jidx.to_state(), metric=metric,
                                  device="cpu")
    rng = np.random.default_rng(5)
    q = data[:64] + 0.05 * rng.standard_normal((64, 48)).astype(np.float32)
    for mode in ("fast", "accurate"):
        jd, jr = jidx.search_batch(q, 10, mode)
        td, tr = tidx.search_batch(q, 10, mode)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def test_build_hnsw_index_passes_the_large_options_on(monkeypatch):
    monkeypatch.setattr(tlarge, "LARGE_N", 400)
    calls = []
    real = tlarge.build_layer_clustered

    def spy(vectors, v_sq, member_rows, **kw):
        calls.append((len(member_rows), kw))
        return real(vectors, v_sq, member_rows, **kw)
    monkeypatch.setattr(tlarge, "build_layer_clustered", spy)
    idx = build_hnsw_index(BUCKET_DATA, M=8, large_probe_clusters=3,
                           large_refine_rounds=0, device="cpu")
    # layer 0 (cap 2M, k_cand as given) and layer 1 (~750 rows: cap M,
    # k_cand at most 4M) take the bucketed builder
    assert [n for n, _ in calls][:2] == [1500, int((idx.graph.levels >= 1)
                                                   .sum())]
    assert len(calls) == 2
    for (_, kw), cap in zip(calls, (16, 8)):
        assert kw["n_probe_clusters"] == 3 and kw["refine_rounds"] == 0
        assert kw["cap"] == cap
    assert calls[1][1]["k_cand"] <= 32
    assert (idx.graph.adj0.numpy()[:1500] >= 0).any(axis=1).all()


@pytest.mark.parametrize("spill", [False, True])
def test_build_graph_pools_rows_by_their_nearest_centroids(monkeypatch,
                                                           spill):
    """build_graph asks the bucketed builder for spill pools (a cell pools
    every row that has it among its n_probe_clusters + 1 nearest
    centroids). On 64 Zipf-sized topics in about 70 cells, the reference's
    cell-to-cell pools leave topics that k-means split in pieces the search
    cannot cross; the spill pools answer as the exact builder does."""
    from hnsw_tpu_torch.io.datagen import generate_vectors
    x = generate_vectors(3500, 64, distribution="embedding",
                         num_clusters=64, seed=3)
    corpus, queries = x[:3000], x[3000:]
    truth = np.argsort(-(queries @ corpus.T), axis=1)[:, :10]
    real = tlarge.build_layer_clustered
    seen = []

    def cells_of_43(*a, **kw):
        seen.append(kw["spill"])
        return real(*a, **dict(kw, cluster_size=43, spill=spill))
    monkeypatch.setattr(tlarge, "LARGE_N", 2999)
    monkeypatch.setattr(tlarge, "build_layer_clustered", cells_of_43)
    idx = build_hnsw_index(corpus, M=16, device="cpu")
    assert seen == [True]
    _, rows = idx.search_batch(queries, 10, "balanced", ef=200)
    got = recall(rows.numpy(), truth)
    if spill:
        assert got >= 0.99, got
    else:
        assert got < 0.97, got

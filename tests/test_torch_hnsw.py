"""Port of HNSW (hnsw_tpu_torch/models/hnsw) against the JAX package, on the
CPU, plus the port's package rules.

1. Search parity on an identical graph: the JAX package builds the graph,
   convert.from_reference carries it across, and both search it. Rows must
   be identical for >= 99% of queries (bf16 shadows, int8 codes and f32
   sums in another order reorder only near-ties), and where rows agree the
   distances agree to 1e-5 (both re-rank in f32); for euclidean that bound
   holds for d^2 / (2 max|v|^2), the domain where the f32 error of
   |q|^2 + |v|^2 - 2 dot is additive.
2. Build parity: the same levels, a mean adj0 row-set overlap of >= 0.98 at
   build_precision="highest" and >= 0.95 at "bf16", and recall no worse
   than the JAX-built graph's minus 0.01.
3. Wave-insert parity: add_batch on a JAX-built graph carried across, against
   the JAX add_batch on the same graph: the same levels and entry, a mean
   adjacency row-set overlap of >= 0.98, and the JAX tests' recall bars
   after insert (tests/test_hnsw.py:85-128).
4. Package rules: no JAX and nothing of hnsw_tpu in the port, and no
   silent fall back to the CPU.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.models.hnsw import HNSWIndex as JHNSWIndex
from hnsw_tpu.models.hnsw import build_hnsw_index as j_build_hnsw_index
from hnsw_tpu.models.hnsw import build as jbuild
from hnsw_tpu.models.hnsw.build import build_graph as j_build_graph
from hnsw_tpu.types import Corpus as JCorpus

from hnsw_tpu_torch import convert
from hnsw_tpu_torch.models.hnsw import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.hnsw import build as tbuild
from hnsw_tpu_torch.models.hnsw.build import build_graph
from hnsw_tpu_torch.types import Corpus
from tests.conftest import brute_force_knn, make_clustered, make_unit
from tests.torch_support import recall

REPO = pathlib.Path(__file__).resolve().parent.parent
N, DIM, NQ = 1000, 64, 200


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(metric):
    x = make_clustered(N, DIM, k=12, seed=31)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.fixture(scope="module")
def jax_built():
    """JAX-built graphs and their to_state(), per metric."""
    out = {}
    for metric in ("cosine", "euclidean"):
        data = _data(metric)
        c = JCorpus.from_array(data, metric=metric)
        g = j_build_graph(c, m=16)
        out[metric] = (data, c, g, JHNSWIndex(c, g).to_state())
    return out


def _queries(data):
    rng = np.random.default_rng(5)
    return data[:NQ] + 0.05 * rng.standard_normal((NQ, DIM)).astype(
        np.float32)


def _parity(jd, jr, td, tr, metric, data):
    jd, jr, td, tr = (np.asarray(x) for x in (jd, jr, td, tr))
    same = (jr == tr).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    if metric == "euclidean":
        scale = 2 * float((data * data).sum(1).max())
        td, jd = td ** 2 / scale, jd ** 2 / scale
    np.testing.assert_allclose(td[same], jd[same], atol=1e-5)
    assert (tr >= 0).all()


@pytest.mark.parametrize("metric,kw,mode", [
    ("cosine", {}, "balanced"),
    ("cosine", dict(pack_precision="int8"), "balanced"),
    ("cosine", dict(pack_dim=32), "fast"),
    ("cosine", dict(pack_dim=100), "fast"),
    ("cosine", dict(entry_mode="hierarchy"), "turbo"),
    ("euclidean", {}, "balanced"),
    ("euclidean", dict(entry_mode="hierarchy"), "fast"),
])
def test_search_parity_on_identical_graph(jax_built, metric, kw, mode):
    data, jc, jg, state = jax_built[metric]
    q = _queries(data)
    jidx = JHNSWIndex(jc, jg, **kw)
    jd, jr = jidx.search_batch(q, 10, mode)
    tidx = convert.from_reference(data, state, metric=metric, device="cpu",
                                  **kw)
    td, tr = tidx.search_batch(q, 10, mode)
    _parity(jd, jr, td, tr, metric, data)


def test_state_round_trip_and_shape_check(jax_built):
    data, jc, jg, state = jax_built["cosine"]
    tidx = convert.from_reference(data, state, metric="cosine", device="cpu")
    back = tidx.to_state()
    assert back["params"] == state["params"]
    for name, arr in state["arrays"].items():
        np.testing.assert_array_equal(back["arrays"][name], arr)
    info = tidx.index_info()
    assert info["element_count"] == N and info["type"] == "hnsw"
    with pytest.raises(ValueError):
        convert.from_reference(data[:-9], state, metric="cosine",
                               device="cpu")


def _overlap(a, b):
    n = min(len(a), len(b))
    scores = []
    for x, y in zip(a[:n], b[:n]):
        sx, sy = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        scores.append(len(sx & sy) / max(len(sx | sy), 1))
    return float(np.mean(scores))


@pytest.mark.parametrize("precision,bar", [("highest", 0.98), ("bf16", 0.95)])
def test_build_parity(jax_built, precision, bar):
    data = _data("cosine")
    jc = JCorpus.from_array(data, metric="cosine")
    jg = jax_built["cosine"][2] if precision == "bf16" else \
        j_build_graph(jc, m=16, build_precision=precision)
    tc = Corpus.from_array(data, metric="cosine", device="cpu")
    tg = build_graph(tc, m=16, build_precision=precision)
    np.testing.assert_array_equal(tg.levels.numpy(), np.asarray(jg.levels))
    assert (tg.max_level, tg.entry, tg.m0) == (jg.max_level, jg.entry, jg.m0)
    ov = _overlap(tg.adj0.numpy()[:N], np.asarray(jg.adj0)[:N])
    assert ov >= bar, ov
    q = _queries(data)
    _, exact = brute_force_knn(data, q, 10, "cosine")
    _, jr = JHNSWIndex(jc, jg).search_batch(q, 10, "fast")
    _, tr = HNSWIndex(tc, tg).search_batch(q, 10, "fast")
    assert recall(tr.numpy(), exact) >= recall(np.asarray(jr), exact) - 0.01


def _insert_pair(data, n0, waves, m=8):
    """JAX-built graph on data[:n0], carried across; both packages then add
    the given waves of rows."""
    j = j_build_hnsw_index(data[:n0], M=m)
    t = convert.from_reference(data[:n0], j.to_state(), metric="cosine",
                               device="cpu")
    for lo, hi in waves:
        j.add_batch(data[lo:hi])
        t.add_batch(data[lo:hi])
    return j, t


def _graph_parity(j, t, n):
    np.testing.assert_array_equal(t.graph.levels.numpy(),
                                  np.asarray(j.graph.levels))
    assert (t.graph.entry, t.graph.max_level, t.graph.n) == \
        (j.graph.entry, j.graph.max_level, j.graph.n) and t.graph.n == n
    ov = _overlap(t.graph.adj0.numpy()[:n], np.asarray(j.graph.adj0)[:n])
    assert ov >= 0.98, ov
    levels = t.graph.levels.numpy()
    for l in range(t.graph.max_level):
        members = np.nonzero(levels >= l + 1)[0]
        if len(members) < 2:
            continue
        a = t.graph.adj_upper[l].numpy()[members]
        b = np.asarray(j.graph.adj_upper)[l][members]
        # a node with no edge on this layer in both graphs agrees
        both_empty = ((a < 0).all(1) & (b < 0).all(1)).sum()
        ov = (_overlap(a, b) * len(members) + both_empty) / len(members)
        assert ov >= 0.98, (l, ov)


def test_add_batch_matches_reference():
    data = make_unit(600, 32, seed=5)
    j, t = _insert_pair(data, 400, [(400, 600)])
    _graph_parity(j, t, 600)
    q = data[:16]
    _, exact = brute_force_knn(data, q, 10, "cosine")
    _, jr = j.search_batch(q, 10, ef=100)
    _, tr = t.search_batch(q, 10, ef=100)
    assert recall(tr.numpy(), exact) >= 0.9
    assert recall(tr.numpy(), exact) >= recall(np.asarray(jr), exact) - 0.01
    # new nodes are findable
    hit = t.search(data[450], 1)[0]
    assert int(hit["id"]) == 450 and hit["distance"] < 1e-3


def test_many_successive_small_waves():
    """The add-heavy pattern of the stateful API, as tests/test_hnsw.py runs
    it: 15 waves of 32 keep the graph searchable at its recall bar. (The
    JAX side is left out here: it recompiles for every wave.)"""
    data = make_unit(640, 32, seed=11)
    t = build_hnsw_index(data[:160], M=8, device="cpu")
    for start in range(160, 640, 32):
        t.add_batch(data[start:start + 32])
    assert t.graph.n == 640
    q = data[::40]
    _, exact = brute_force_knn(data, q, 10, "cosine")
    _, rows = t.search_batch(q, 10, ef=128)
    assert recall(rows.numpy(), exact) >= 0.92


def test_add_batch_within_pad_slack_and_with_ids():
    """An add small enough not to grow N_pad must still drop the cached bf16
    shadow and pack (else new rows score against stale rows and vanish);
    string ids grow with the corpus."""
    data = make_unit(1008, 32, seed=7)
    t = build_hnsw_index(data[:1001], M=8, device="cpu",
                         ids=[f"v{i}" for i in range(1001)])
    t.search(data[0], 1)                      # builds the shadow and pack
    n_pad = t.corpus.n_pad
    t.add_batch(data[1001:], ids=[f"new{i}" for i in range(7)])
    assert t.corpus.n_pad == n_pad and t.graph.n == 1008
    hits = t.search(data[1003], 1)
    assert hits[0]["id"] == "new2" and hits[0]["distance"] < 1e-3
    assert t.corpus.device.type == "cpu"


def test_select_from_candidates_matches_reference():
    """Candidate dedupe (later duplicates, self), stable distance sort and
    the heuristic, on candidate lists full of repeats."""
    rng = np.random.default_rng(12)
    data = make_unit(200, 32, seed=13)
    jc = JCorpus.from_array(data, metric="cosine")
    tc = Corpus.from_array(data, metric="cosine", device="cpu")
    self_ids = np.arange(16, dtype=np.int32)
    cand = rng.integers(-1, 60, (16, 40)).astype(np.int32)
    want = jbuild.select_from_candidates(
        jc.vectors[:16], jnp.asarray(cand), jc.vectors, jc.sq_norms,
        jnp.asarray(self_ids), cap=8, metric=JCorpus.from_array(
            data[:1]).metric)
    got = tbuild.select_from_candidates(
        tc.vectors[:16], torch.from_numpy(cand), tc.vectors, tc.sq_norms,
        torch.from_numpy(self_ids), cap=8, metric="cosine")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reverse_edges_keep_every_group_start():
    """Divergence on purpose (ROADMAP §C): the reference's _reverse_device
    binary-searches the group starts over an array whose invalid (-1) edges
    sit unsorted at the end, so some groups of the highest ids get a wrong
    start and lose reverse edges. The port maps the tail above every id
    first and so agrees with the host reverse_candidates exactly."""
    rng = np.random.default_rng(9)
    ns_pad, n, cap = 1024, 1000, 8
    fwd = rng.integers(0, n, (ns_pad, cap)).astype(np.int32)
    fwd[rng.random(fwd.shape) < 0.2] = -1
    fwd[n:] = -1
    fwd_d = rng.random(fwd.shape).astype(np.float32)
    want = tbuild.reverse_candidates(fwd, ns_pad, cap)
    got, _ = tbuild._reverse_device(torch.from_numpy(fwd),
                                    torch.from_numpy(fwd_d), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    ref, _ = jbuild._reverse_device(jnp.asarray(fwd), jnp.asarray(fwd_d),
                                    cap)
    assert (np.asarray(ref) != want).any()


def test_host_layer_path_matches_reference():
    x = _data("euclidean")[:300]
    for metric in ("cosine", "euclidean", "dot"):
        np.testing.assert_array_equal(
            tbuild._build_layer_host(x, cap=16, k_cand=48, metric=metric),
            jbuild._build_layer_host(x, cap=16, k_cand=48, metric=metric))


def test_entry_points_default_to_the_card_and_never_drop_to_the_cpu():
    data = _data("cosine")[:50]
    if torch.cuda.is_available():
        assert Corpus.from_array(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Corpus.from_array(data)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_hnsw_index(data)
    idx = build_hnsw_index(data, device="cpu")
    assert idx.corpus.device.type == "cpu"
    assert idx.graph.adj0.device.type == "cpu"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hnsw_tpu_torch, hnsw_tpu_torch.models, "
            "hnsw_tpu_torch.convert, hnsw_tpu_torch.ops.scan, "
            "hnsw_tpu_torch.ops.hop; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'hnsw_tpu' or "
            "m.startswith('hnsw_tpu.')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_import_statements_in_the_port():
    files = sorted((REPO / "hnsw_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    pat = re.compile(r"^\s*(import\s+(jax|hnsw_tpu)\b(?!_torch)|"
                     r"from\s+(jax|hnsw_tpu)(\.|\s)(?!.*_torch))", re.M)
    for f in files:
        src = f.read_text()
        assert not pat.search(src), f

"""The search as one device program, on the CPU, against the JAX package.

On the card the port's hop loop runs exactly max_hops bodies (no host sync)
and its greedy descent is one kernel launch; on the CPU both keep their
early exit. Here, on graphs built by the JAX package and carried across with
convert.from_reference:

(a) the fixed-length hop loop (the card's form, forced on the CPU) against
    JAX's jitted hnsw_search_batch for every merge, single-entry search with
    upper layers, multi-entry seeds, the bf16, int8 and pack_dim packs and
    the f32 ("highest") path: rows identical for >= 0.99 of queries,
    distances within 1e-5 where they are (euclidean as d^2 / 2 max|v|^2, as
    tests/test_torch_hnsw.py holds them), the same hop count, and the
    early-exit form giving the same rows, distances and hops bit for bit;
(b) greedy_descent_plain against JAX's _greedy_descent walked layer by
    layer: identical endpoints and cur_d within 1e-5, for bf16 and f32
    vectors, and on a corpus of duplicate rows, where the walk must take
    the first of equal minima;
(c) hnsw_tpu_torch.entry.entry(device="cpu")'s fn on the graph that
    __graft_entry__.entry() builds, against that fn.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from hnsw_tpu.models.hnsw import search as jsearch
from hnsw_tpu.ops import pallas_hop
from hnsw_tpu.models.hnsw.build import build_graph as j_build_graph
from hnsw_tpu.models.hnsw import HNSWIndex as JHNSWIndex
from hnsw_tpu.types import Corpus as JCorpus, Metric as JMetric

from hnsw_tpu_torch import convert
from hnsw_tpu_torch.entry import entry
from hnsw_tpu_torch.models.hnsw import search as tsearch
from hnsw_tpu_torch.ops import descent
from tests.conftest import make_clustered

N, DIM, NQ, K, EF = 1000, 64, 120, 10, 48


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _parity(jd, jr, td, tr, metric, data):
    jd, jr, td, tr = (np.asarray(x) for x in (jd, jr, td, tr))
    same = (jr == tr).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    if metric == "euclidean":
        scale = 2 * float((data * data).sum(1).max())
        td, jd = td ** 2 / scale, jd ** 2 / scale
    np.testing.assert_allclose(td[same], jd[same], atol=1e-5)
    assert (tr >= 0).all()


def _data(metric):
    x = make_clustered(N, DIM, k=12, seed=31)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


@pytest.fixture(scope="module")
def graphs():
    """Per metric: data, the JAX corpus and graph, the port's index over the
    same graph, and queries near corpus rows."""
    out = {}
    rng = np.random.default_rng(5)
    for metric in ("cosine", "euclidean"):
        data = _data(metric)
        jc = JCorpus.from_array(data, metric=metric)
        jg = j_build_graph(jc, m=8)
        t = convert.from_reference(data, JHNSWIndex(jc, jg).to_state(),
                                   metric=metric, device="cpu")
        q = data[:NQ] + 0.05 * rng.standard_normal((NQ, DIM)).astype(
            np.float32)
        for got, want in ((t.corpus.vectors, jc.vectors),
                          (t.graph.adj0, jg.adj0),
                          (t.graph.adj_upper, jg.adj_upper)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        out[metric] = (data, jc, jg, t, np.asarray(jc.pad_queries(q)))
    assert out["cosine"][2].max_level >= 1
    return out


def _inputs(case, graphs):
    """(metric, shared numpy arrays, search keywords) of one case. Arrays
    with a "_bf16" name are rounded to bf16 by each package."""
    metric = "euclidean" if case == "highest_euclidean" else "cosine"
    data, jc, jg, t, q = graphs[metric]
    # the carried index's arrays, which the fixture holds equal to JAX's
    vectors = t.corpus.vectors.numpy()
    v_sq = np.asarray(jc.sq_norms)
    adj0 = t.graph.adj0.numpy()
    upper = t.graph.adj_upper.numpy()
    b = q.shape[0]
    arrays = dict(vectors=vectors, v_sq=v_sq, adj0=adj0, queries=q,
                  vectors_lp_bf16=vectors)
    kw = dict(k=K, ef=EF, precision="default")
    rng = np.random.default_rng(3)
    if case == "multi_entry":
        seeds = rng.integers(0, N, (b, 4)).astype(np.int32)
        seeds[:, 3] = seeds[:, 0]                   # a duplicate seed
        seeds[::7, 2] = -1                          # a missing one
        arrays.update(entries=seeds, adj_upper=upper[:0])
    elif case == "hierarchy" or case.startswith("highest"):
        # the graph's entry point and the descent through every layer
        arrays.update(entries=np.full((b,), jg.entry, np.int32),
                      adj_upper=upper)
    else:
        # a row per query and no upper layers, as entry_mode="sample"
        arrays.update(entries=rng.integers(0, N, b).astype(np.int32),
                      adj_upper=upper[:0])
    rows = np.maximum(adj0, 0)
    if case == "bf16_pack":
        arrays.update(nbr_pack_bf16=vectors[rows], nbr_sq=v_sq[rows])
    elif case == "int8_pack":
        codes, scale, sq = tsearch.pack_neighbors_int8(
            torch.from_numpy(np.array(vectors)).to(torch.bfloat16),
            torch.from_numpy(np.array(v_sq)), torch.from_numpy(adj0))
        arrays.update(nbr_pack=codes.numpy(), nbr_scale=scale.numpy(),
                      nbr_sq=sq.numpy())
    elif case == "pack_dim":
        basis, _ = np.linalg.qr(np.random.default_rng(8).standard_normal(
            (vectors.shape[1], 16)).astype(np.float32))
        basis = basis.astype(np.float32)
        low = torch.from_numpy(vectors @ basis).to(torch.bfloat16).float()
        low_sq = (low * low).sum(-1).numpy()
        arrays.update(queries_lp=q @ basis, vectors_lp_bf16=low.numpy(),
                      v_sq_lp=low_sq,
                      nbr_pack_bf16=low.numpy()[rows], nbr_sq=low_sq[rows])
        kw.update(rerank=4 * K)
    elif case.startswith("highest"):
        kw.update(precision="highest")
        del arrays["vectors_lp_bf16"]
    elif case in ("sort", "topk", "onehot", "bitonic", "approx"):
        kw.update(merge=case)
    return metric, data, arrays, kw


def _as(arrays, to_jax: bool):
    out = {}
    for name, a in arrays.items():
        key = name.removesuffix("_bf16")
        if to_jax:
            x = jnp.asarray(a)
            out[key] = x.astype(jnp.bfloat16) if name.endswith("_bf16") else x
        else:
            x = torch.from_numpy(np.array(a))
            out[key] = x.to(torch.bfloat16) if name.endswith("_bf16") else x
    return out


def _call(search, a, metric, kw, metric_type):
    rest = {n: a[n] for n in ("vectors_lp", "nbr_pack", "nbr_sq",
                              "nbr_scale", "queries_lp", "v_sq_lp")
            if n in a}
    return search(a["vectors"], a["v_sq"], a["adj0"], a["adj_upper"],
                  a["entries"], a["queries"], metric=metric_type(metric),
                  debug_hops=True, **rest, **kw)


CASES = ["sort", "topk", "onehot", "bitonic", "approx", "hierarchy",
         "multi_entry", "bf16_pack", "int8_pack", "pack_dim",
         "highest_cosine", "highest_euclidean"]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX search's bf16 pack scored by its Pallas kernel (the port's
    hop_score takes the squared norms from the block, as that kernel does),
    in interpret mode on the CPU."""
    orig = pallas_hop.hop_score
    monkeypatch.setattr(pallas_hop, "hop_score",
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("case", CASES)
def test_fixed_length_hop_loop_matches_reference(case, graphs, monkeypatch,
                                                 pallas_interpret):
    metric, data, arrays, kw = _inputs(case, graphs)
    jkw = dict(kw, hop_kernel="pallas") if "nbr_pack_bf16" in arrays else kw
    jd, jr, jhops = _call(jsearch.hnsw_search_batch, _as(arrays, True),
                          metric, jkw, JMetric)
    t = _as(arrays, False)
    ed, er, ehops = _call(tsearch.hnsw_search_batch, t, metric, kw, str)
    monkeypatch.setattr(tsearch, "_runs_fixed_length", lambda dev: True)
    fd, fr, fhops = _call(tsearch.hnsw_search_batch, t, metric, kw, str)
    # the card's form is the early-exit loop exactly
    assert torch.equal(fr, er) and torch.equal(fd, ed) and fhops == ehops
    assert fhops == int(jhops) and 0 < fhops <= 2 * (EF // 4) + 16
    _parity(jd, jr, fd.numpy(), fr.numpy(), metric, data)


def _descend_reference(q, cur, cur_d, upper, vectors, v_sq, metric, prec):
    for l in range(upper.shape[0] - 1, -1, -1):
        cur, cur_d = jsearch._greedy_descent(q, cur, cur_d, upper[l],
                                             vectors, v_sq, JMetric(metric),
                                             prec)
    return np.asarray(cur), np.asarray(cur_d)


@pytest.mark.parametrize("metric,dtype", [("cosine", "bf16"),
                                          ("cosine", "f32"),
                                          ("euclidean", "f32"),
                                          ("duplicates", "bf16")])
def test_greedy_descent_plain_matches_reference(metric, dtype, graphs):
    if metric == "duplicates":
        # every row one of 40 vectors: neighbourhoods hold exact ties, and
        # both walks must take the first of them
        data, _, jg, _, q = graphs["cosine"]
        base = np.asarray(JCorpus.from_array(data).vectors)
        rng = np.random.default_rng(4)
        vectors = base[rng.integers(0, 40, base.shape[0])]
        metric = "cosine"
    else:
        data, jc, jg, _, q = graphs[metric]
        vectors = np.asarray(jc.vectors)
    v_sq = (vectors * vectors).sum(1).astype(np.float32)
    upper = np.asarray(jg.adj_upper)
    # walks from rows of the upper layers (the graph's entry first)
    members = np.nonzero(np.asarray(jg.levels) >= 1)[0]
    start = np.random.default_rng(6).choice(members, q.shape[0]) \
        .astype(np.int32)
    start[0] = jg.entry
    prec = "default" if dtype == "bf16" else "highest"
    jv = jnp.asarray(vectors)
    tv = torch.from_numpy(vectors)
    if dtype == "bf16":
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    d0 = jsearch._score(jq, jnp.asarray(start)[:, None], jv,
                        jnp.asarray(v_sq), JMetric(metric),
                        jnp.ones((q.shape[0], 1), bool), prec)[:, 0]
    want_cur, want_d = _descend_reference(
        jq, jnp.asarray(start), d0, jnp.asarray(upper), jv,
        jnp.asarray(v_sq), metric, prec)
    visits = []
    got_cur, got_d = descent.greedy_descent_plain(
        tq, (tq * tq).sum(-1), torch.from_numpy(start),
        torch.from_numpy(np.asarray(d0)), torch.from_numpy(upper), tv,
        torch.from_numpy(v_sq), metric, visits=visits)
    np.testing.assert_array_equal(got_cur.numpy(), want_cur)
    got_dn = got_d.numpy()
    if metric == "euclidean":
        # f32 |q|^2 + |v|^2 - 2 dot: the error is additive in d^2, so d is
        # held as in _parity, d^2 / (2 max |v|^2)
        scale = 2 * float(v_sq.max())
        got_dn, want_d = got_dn ** 2 / scale, want_d ** 2 / scale
    np.testing.assert_allclose(got_dn, want_d, atol=1e-5)
    assert (got_cur.numpy() != start).mean() > 0.5 and len(visits) > 1
    # on a CPU tensor the wrapper is its plain version and counts nothing
    before = descent.greedy_descent.launches
    cur2, d2 = descent.greedy_descent(
        tq, (tq * tq).sum(-1), torch.from_numpy(start),
        torch.from_numpy(np.asarray(d0)), torch.from_numpy(upper), tv,
        torch.from_numpy(v_sq), metric)
    assert torch.equal(cur2, got_cur) and torch.equal(d2, got_d)
    assert descent.greedy_descent.launches == before


def test_entry_twin_matches_graft_entry():
    jfn, jargs = graft.entry()
    tfn, targs = entry(device="cpu")
    assert [tuple(a.shape) for a in targs] == \
        [tuple(np.shape(a)) for a in jargs]
    np.testing.assert_array_equal(targs[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(targs[5].numpy(), np.asarray(jargs[5]))
    jd, jr = jfn(*jargs)
    carried = [torch.from_numpy(np.array(a)) for a in jargs]
    td, tr = tfn(*carried)
    data = graft._tiny_data(512, 64)
    _parity(jd, jr, td.numpy(), tr.numpy(), "cosine", data)
    # on the port's own graph each query finds itself first
    _, own = tfn(*targs)
    assert (own[:, 0].numpy() == np.arange(32)).mean() >= 0.9

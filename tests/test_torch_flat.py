"""Port of the flat index (hnsw_tpu_torch/models/flat.py) against the JAX
FlatIndex on the same numpy data, on the CPU.

The f32 scan is exact on both sides: rows must be identical and distances
agree to 1e-5 (f32 sums in another order). The bf16 and int8 forms are
approximate by design and are held to the reference tests' recall bars
(test_pallas_scan.py, test_pallas_hop.py): >= 0.98 for bf16 and for int8
with re-rank, >= 0.95 for int8 coarse-only. The kernel routes that the card
takes (every scan_kernel) run here through the kernels' plain versions and
are held against the JAX FlatIndex's Pallas routes in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from hnsw_tpu.models.flat import FlatIndex as JFlatIndex
from hnsw_tpu.types import Corpus as JCorpus

from hnsw_tpu_torch.models.flat import FlatIndex, build_flat_index
from hnsw_tpu_torch.types import Corpus
from tests.conftest import brute_force_knn, make_clustered, make_unit
from tests.torch_support import recall

METRICS = ["cosine", "euclidean", "dot"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(data, metric, **kw):
    j = JFlatIndex(JCorpus.from_array(data, metric=metric), **kw)
    t = FlatIndex(Corpus.from_array(data, metric=metric, device="cpu"), **kw)
    return j, t


@pytest.mark.parametrize("metric", METRICS)
def test_f32_rows_identical(metric):
    data = make_clustered(700, 48, seed=11)
    # tile < n_pad exercises the streamed running merge
    j, t = _pair(data, metric, tile=256)
    q = data[:64] + 0.01
    jd, jr = j.search_batch(q, 10)
    td, tr = t.search_batch(q, 10)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    if metric == "euclidean":
        # d = sqrt(|q|^2 + |v|^2 - 2 dot): the f32 sum-order error is
        # additive in d^2 and scales with the squared norms
        scale = 2 * float((data * data).sum(1).max())
        np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2,
                                   atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                                   rtol=1e-6)
    _, exact = brute_force_knn(data, q, 10, metric)
    assert recall(tr.numpy(), exact) == 1.0


def test_f32_k_beyond_n_and_row_mask():
    data = make_unit(9, 32, seed=12)
    j, t = _pair(data, "cosine")
    jd, jr = j.search_batch(data[:3], 12)
    td, tr = t.search_batch(data[:3], 12)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:, 9:] == -1).all()
    mask = np.arange(9) % 2 == 1
    jd, jr = j.search_batch(data[:3], 4, row_mask=mask)
    td, tr = t.search_batch(data[:3], 4, row_mask=mask)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy() % 2 == 1).all()
    hits = t.search_filtered(data[0], 3, lambda i: int(i) >= 5)
    assert [h["id"] for h in hits] == \
        [h["id"] for h in j.search_filtered(data[0], 3, lambda i: int(i) >= 5)]


@pytest.mark.parametrize("precision,fetch,bar", [
    ("bf16", None, 0.98), ("int8", None, 0.98), ("int8", 0, 0.95)])
def test_low_precision_recall_bars(precision, fetch, bar):
    data = make_unit(1500, 64, seed=13)
    q = data[:96]
    _, exact = brute_force_knn(data, q, 10, "cosine")
    j, t = _pair(data, "cosine", precision=precision, int8_fetch=fetch)
    jd, jr = j.search_batch(q, 10)
    td, tr = t.search_batch(q, 10)
    assert recall(np.asarray(jr), exact) >= bar
    assert recall(tr.numpy(), exact) >= bar
    assert tr.shape == (96, 10) and torch.isfinite(td).all()
    assert (np.diff(td.numpy(), axis=1) >= -1e-5).all()
    # the path the card takes (the fused bucketed scans), run here through
    # the kernels' plain versions on CPU tensors
    qp = t.corpus.pad_queries(q)
    if precision == "bf16":
        kd, kr = t._bf16_kernel(qp, 10)
    else:
        kd, kr = t._int8_kernel(qp, 10, 16 if fetch is None else 0)
    assert recall(kr.numpy(), exact) >= bar
    assert (kr.numpy() >= 0).all() and (kr.numpy() < 1500).all()
    # reported distances: exact after re-rank, else within bf16 / int8
    # rounding of the exact ones (1e-2, test_pallas_scan.py's bound)
    de, _ = brute_force_knn(data, q, 10, "cosine")
    atol = 1e-5 if (precision == "int8" and fetch is None) else 1e-2
    np.testing.assert_allclose(kd.numpy()[:, 0], de[:, 0], atol=atol)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX FlatIndex's kernel routes here: its Pallas scans in
    interpret mode (looked up at call time by FlatIndex), and its bf16 route
    switched on (it is taken only on a TPU backend)."""
    from hnsw_tpu.ops import pallas_scan as jscan
    for name in ("pallas_bucket_topk", "pallas_exact_topk",
                 "pallas_int8_bucket_topk", "pallas_int8_topk",
                 "pallas_int8_packed_topk"):
        monkeypatch.setattr(jscan, name, functools.partial(
            getattr(jscan, name), interpret=True))
    monkeypatch.setattr(JFlatIndex, "_pallas_ready", lambda self, k: True)


def _same_rows(jd, jr, td, tr, metric, data, atol):
    jd, jr, td, tr = (np.asarray(x) for x in (jd, jr, td, tr))
    same = (jr == tr).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    if metric == "euclidean":
        scale = 2 * float((data * data).sum(1).max())
        td, jd = td ** 2 / scale, jd ** 2 / scale
    np.testing.assert_allclose(td[same], jd[same], atol=atol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision,scan_kernel", [
    (p, s) for p in ("bf16", "int8")
    for s in ("auto", "bucket", "sweep", "packed")])
def test_scan_kernel_dispatch_matches_reference(pallas_interpret, precision,
                                                scan_kernel, metric):
    """Every scan_kernel x precision x metric routes as in the reference
    (bf16: sweep, else bucket; int8: sweep, packed for cosine/dot, else
    bucket; re-rank and coarse-only), and the route's result matches the
    JAX FlatIndex's through its Pallas kernels. Distances: f32 re-rank
    1e-5; bf16 keys and int8 coarse keys differ only in f32 sum order."""
    data = make_unit(300, 32, seed=15)
    j, t = _pair(data, metric, precision=precision, scan_kernel=scan_kernel)
    q = data[:24] + 0.01
    tq = t.corpus.pad_queries(q)
    if precision == "bf16":
        jd, jr = j.search_batch(q, 10)
        td, tr = t._bf16_kernel(tq, 10)
        _same_rows(jd, jr, td, tr, metric, data, 1e-5)
    else:
        jq = j.corpus.pad_queries(q)
        for fetch in (16, 0):
            jd, jr = j._int8_pallas(jq, 10, fetch)
            td, tr = t._int8_kernel(tq, 10, fetch)
            _same_rows(jd, jr, td, tr, metric, data, 1e-5)
    assert tr.shape == (24, 10) and (tr.numpy() >= 0).all()


def test_packed_dot_guard_takes_the_bucket_kernel(pallas_interpret):
    """Deliberate divergence (ROADMAP §C): on an unnormalized DOT corpus the
    packed key dots*(-vscale) + PACK_BIAS goes negative, its int32 bits
    then order backwards, and the reference's packed route returns wrong
    candidates. The port checks the stated bound and takes the bucket
    kernel, whose rows it then matches."""
    rng = np.random.default_rng(16)
    # 16 rows per bucket, so the inverted order picks the wrong best two
    data = (100.0 * rng.standard_normal((2048, 32))).astype(np.float32)
    q = data[:24]
    _, exact = brute_force_knn(data, q, 10, "dot")
    j, t = _pair(data, "dot", precision="int8", scan_kernel="packed")
    jb = JFlatIndex(JCorpus.from_array(data, metric="dot"), precision="int8",
                    scan_kernel="bucket")
    jq, tq = j.corpus.pad_queries(q), t.corpus.pad_queries(q)
    for fetch in (16, 0):
        td, tr = t._int8_kernel(tq, 10, fetch)
        bd, br = jb._int8_pallas(jq, 10, fetch)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(br))
        assert recall(tr.numpy(), exact) >= 0.95
        _, pr = j._int8_pallas(jq, 10, fetch)
        assert recall(np.asarray(pr), exact) < 0.1
    assert t._packed_ok is False
    # a unit-norm DOT corpus stays inside the bound and keeps "packed"
    unit = FlatIndex(Corpus.from_array(make_unit(300, 32), metric="dot",
                                       device="cpu"),
                     precision="int8", scan_kernel="packed")
    unit._int8_kernel(unit.corpus.pad_queries(q[:2] / 100.0), 5, 0)
    assert unit._packed_ok is True


def test_build_flat_index_defaults_to_the_card():
    data = make_unit(20, 16)
    if torch.cuda.is_available():
        assert build_flat_index(data).corpus.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_flat_index(data)
    idx = build_flat_index(data, device="cpu", precision="int8", int8_fetch=0)
    assert idx.corpus.device.type == "cpu"
    state = idx.to_state()
    again = FlatIndex.from_state(idx.corpus, state)
    assert again.to_state() == state == JFlatIndex.from_state(
        JCorpus.from_array(data), state).to_state()

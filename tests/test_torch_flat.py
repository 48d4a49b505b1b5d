"""Port of the flat index (hnsw_tpu_torch/models/flat.py) against the JAX
FlatIndex on the same numpy data, on the CPU.

The f32 scan is exact on both sides: rows must be identical and distances
agree to 1e-5 (f32 sums in another order). The bf16 and int8 forms are
approximate by design and are held to the reference tests' recall bars
(test_pallas_scan.py, test_pallas_hop.py): >= 0.98 for bf16 and for int8
with re-rank, >= 0.95 for int8 coarse-only.
"""

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


def test_unported_scan_kernels_raise_on_the_kernel_path():
    t = FlatIndex(Corpus.from_array(make_unit(50, 16), device="cpu"),
                  precision="bf16", scan_kernel="sweep")
    with pytest.raises(NotImplementedError, match="later slice"):
        t._bf16_kernel(t.corpus.pad_queries(make_unit(2, 16)), 5)


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

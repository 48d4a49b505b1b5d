"""Port of the hashing and projection families (hnsw_tpu_torch/models/
lsh.py, pcaf.py) against the JAX package, on the CPU.

1. LSH: identical hyperplanes, buckets and overflow counts (the host hash
   is the reference's numpy code); _query_buckets gives identical bucket
   ids wherever every bit's |score| exceeds 1e-5 (both flip orders); the
   chunked gather returns the rows of one unchunked call.
2. PCAF: basis="random" gives the identical proj; basis="pca" reaches the
   JAX package's recall band.
3. Both families built by the JAX package and carried across
   (convert.from_reference) return identical rows at every mode (LSH with
   margin and fixed flips, PCAF with both bases), distances within 1e-5.
4. Port-built indexes clear tests/test_families.py's bars on its data
   (precise recall 0.5 LSH, 0.6 PCAF).
"""

import numpy as np
import pytest
import torch

import hnsw_tpu
from hnsw_tpu.models import lsh as jlsh
from hnsw_tpu.models.lsh import build_lsh_index as j_build_lsh
from hnsw_tpu.models.pcaf import build_pcaf_index as j_build_pcaf
from hnsw_tpu.types import Corpus as JCorpus

import hnsw_tpu_torch as ht
from hnsw_tpu_torch import convert
from hnsw_tpu_torch.models import lsh as tlsh
from hnsw_tpu_torch.models.lsh import build_lsh_index
from hnsw_tpu_torch.models.pcaf import build_pcaf_index
from tests.conftest import brute_force_knn, make_clustered, recall_at_k

CPU = dict(device="cpu")
MODES = ("turbo", "fast", "balanced", "accurate", "precise")

DATA = make_clustered(1200, 64, k=10, seed=21)      # tests/test_families.py
QUERIES = DATA[:24]
_, EXACT10 = brute_force_knn(DATA, QUERIES, 10, "cosine")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# 1. LSH build and query hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_bits=6),
                                dict(num_tables=2, num_bits=2, bucket_cap=8),
                                dict(num_tables=4, num_bits=4)])
def test_lsh_buckets_and_overflow_match(kw):
    """The default bits, a tiny cap that overflows, and the default cap
    (tests/test_families.py:test_lsh_overflow_is_accounted)."""
    data = DATA if "bucket_cap" not in kw else DATA[:500]
    j = j_build_lsh(data, **kw)
    t = build_lsh_index(data, **kw, **CPU)
    np.testing.assert_array_equal(_np(t.proj), _np(j.proj))
    np.testing.assert_array_equal(_np(t.buckets), _np(j.buckets))
    assert t.bucket_cap == j.bucket_cap
    ti, ji = t.index_info(), j.index_info()
    assert ti == ji
    if "bucket_cap" in kw:
        assert ti["overflow_dropped_slots"] == \
            500 * 2 - int((_np(t.buckets) >= 0).sum()) > 0


@pytest.mark.parametrize("flip_order", ["margin", "fixed"])
def test_query_buckets_match_where_no_bit_is_near_zero(flip_order):
    j = j_build_lsh(DATA)
    q = JCorpus.from_array(DATA).pad_queries(DATA[:200] + 0.05)
    qt = torch.from_numpy(np.array(q))
    for probes, radius in ((2, 1), (6, 3), (8, 4)):
        want = _np(jlsh._query_buckets(q, j.proj, probes=probes,
                                       radius=radius, flip_order=flip_order))
        got = _np(tlsh._query_buckets(qt, torch.from_numpy(np.array(j.proj)),
                                      probes=probes, radius=radius,
                                      flip_order=flip_order))
        scores = np.einsum("bd,tdh->bth", np.asarray(q), np.asarray(j.proj))
        clear = (np.abs(scores) > 1e-5).all(axis=-1)         # [B, T]
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[clear], want[clear])


def test_chunked_gather_returns_the_rows_of_one_call(monkeypatch):
    t = build_lsh_index(DATA, num_bits=6, **CPU)
    whole = t.search_batch(QUERIES, 10, "precise")
    t_cap = t.buckets.shape[-1]
    # a budget of 5 queries' gathered rows: 24 queries in 5 chunks
    monkeypatch.setattr(tlsh, "GATHER_BUDGET_BYTES",
                        5 * 8 * 8 * t_cap * t.corpus.d_pad * 4)
    calls = []
    real = tlsh._lsh_search
    monkeypatch.setattr(tlsh, "_lsh_search",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    chunked = t.search_batch(QUERIES, 10, "precise")
    assert len(calls) == 5
    np.testing.assert_array_equal(_np(chunked[1]), _np(whole[1]))
    np.testing.assert_array_equal(_np(chunked[0]), _np(whole[0]))


# ---------------------------------------------------------------------------
# 2-3. PCAF build; JAX-built indexes carried across
# ---------------------------------------------------------------------------

def test_pcaf_random_basis_is_identical():
    j = j_build_pcaf(DATA, n_components=32, basis="random", seed=5)
    t = build_pcaf_index(DATA, n_components=32, basis="random", seed=5,
                         **CPU)
    np.testing.assert_array_equal(_np(t.proj), _np(j.proj))
    assert t.proj.shape == (128, 128)
    np.testing.assert_allclose(_np(t.low_vectors), _np(j.low_vectors),
                               atol=1e-5)


def test_pcaf_pca_basis_reaches_the_reference_band():
    j = j_build_pcaf(DATA, n_components=32)
    t = build_pcaf_index(DATA, n_components=32, **CPU)
    for mode in ("balanced", "precise"):
        rj = recall_at_k(_np(j.search_batch(QUERIES, 10, mode)[1]), EXACT10)
        rt = recall_at_k(_np(t.search_batch(QUERIES, 10, mode)[1]), EXACT10)
        assert rt >= 0.6 and abs(rt - rj) <= 0.05, (mode, rt, rj)


@pytest.mark.parametrize("family,kw,search_kw", [
    ("hybrid_lsh", dict(num_bits=6), dict(flip_order="margin")),
    ("hybrid_lsh", dict(num_bits=6), dict(flip_order="fixed")),
    ("pcaf", dict(n_components=32), {}),
    ("pcaf", dict(n_components=32, basis="random"), {})])
def test_carried_index_rows_identical(family, kw, search_kw):
    j = hnsw_tpu.build_index(DATA, family, **kw)
    t = convert.from_reference(DATA, j.to_state(), metric="cosine",
                               family=family, **CPU)
    assert type(t).__name__ == type(j).__name__
    for mode in MODES:
        jd, jr = j.search_batch(QUERIES, 10, mode, **search_kw)
        td, tr = t.search_batch(QUERIES, 10, mode, **search_kw)
        np.testing.assert_array_equal(_np(tr), _np(jr))
        np.testing.assert_allclose(_np(td), _np(jd), atol=1e-5)


def test_from_reference_checks_buckets_and_proj():
    j = hnsw_tpu.build_index(DATA, "lsh", num_bits=6)
    with pytest.raises(ValueError, match="buckets name row"):
        convert.from_reference(DATA[:600], j.to_state(), metric="cosine",
                               family="lsh", **CPU)
    p = hnsw_tpu.build_index(DATA, "pcaf", n_components=32)
    with pytest.raises(ValueError, match="padded dims"):
        convert.from_reference(np.zeros((10, 200), np.float32), p.to_state(),
                               metric="cosine", family="pcaf", **CPU)


# ---------------------------------------------------------------------------
# 4. port-built indexes against the JAX tests' bars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,kw,bar", [
    ("hybrid_lsh", dict(num_bits=6), 0.5),
    ("pcaf", dict(n_components=32), 0.6)])
def test_port_built_clears_the_family_bar(fam, kw, bar):
    idx = ht.build_index(DATA, fam, metric="cosine", **kw, **CPU)
    _, rows = idx.search_batch(QUERIES, 10, mode="precise")
    rp = recall_at_k(_np(rows), EXACT10)
    assert rp >= bar, rp
    _, r_turbo = idx.search_batch(QUERIES, 10, mode="turbo")
    assert rp >= recall_at_k(_np(r_turbo), EXACT10) - 0.05
    d, r = idx.search_batch(QUERIES[:4], 10, mode="balanced")
    for qi in range(4):
        real = _np(r)[qi][_np(r)[qi] >= 0]
        assert len(set(real.tolist())) == len(real)
        assert (np.diff(_np(d)[qi][_np(r)[qi] >= 0]) >= -1e-6).all()
    back = type(idx).from_state(idx.corpus, idx.to_state())
    np.testing.assert_array_equal(
        _np(back.search_batch(QUERIES[:4], 5, "balanced")[1]),
        _np(idx.search_batch(QUERIES[:4], 5, "balanced")[1]))
    info = idx.index_info()
    assert (info["num_vectors"], info["dimensions"], info["metric"]) == \
        (1200, 64, "cosine")

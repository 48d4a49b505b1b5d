"""Port of the partition-scan families (hnsw_tpu_torch/models/
_partition_scan.py, ivf_flat.py, lightning.py) against the JAX package, on
the CPU.

1. PartitionTable.build: identical perm, starts, lens and cmax, with and
   without spill; slab vectors bit for bit (f32 and bf16); computed
   centroids within 1e-5. default_qcap: identical.
2. scan_search and grouped_search on tables carried across: identical rows
   and dropped counts; distances within 1e-5 on the f32 paths. The bf16
   paths (a bf16-stored table, the grouped scan below "highest") take f32
   products of bf16-rounded operands: rows agree >= 0.95 and distances
   within 1e-2, test_torch_flat.py's bf16 tolerance. Spill and none,
   cosine and euclidean, a qcap that drops pairs, P * kq < k, and a tie
   across two clusters that the batched merge breaks as the sequential one.
3. IVF-FLAT (both scans) and Lightning (centroid and random probes, the
   same seeded draws) built by the JAX package and carried across
   (convert.from_reference) return identical rows at every mode.
4. Port-built indexes clear the bars of tests/test_families.py and
   tests/test_ivf.py on the same data.
5. The two reference faults not copied (ROADMAP §C): from_state casts a
   bf16 table before its gather, and an explicit bf16 table with
   euclidean raises.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import hnsw_tpu
from hnsw_tpu.io.datagen import generate_vectors
from hnsw_tpu.models import _partition_scan as jps
from hnsw_tpu.types import Corpus as JCorpus

import hnsw_tpu_torch as ht
from hnsw_tpu_torch import convert
from hnsw_tpu_torch.models import _partition_scan as tps
from hnsw_tpu_torch.models.ivf_flat import IVFFlatIndex, build_ivf_flat_index
from hnsw_tpu_torch.types import Corpus
from tests.conftest import brute_force_knn, make_clustered, recall_at_k

CPU = dict(device="cpu")
MODES = ("turbo", "fast", "balanced", "accurate", "precise")
K_PARTS = 6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Many small CPU operators: two threads run them as fast as every
    core, and leave the other cores to the test workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    data = make_clustered(600, 48, k=6, seed=3)
    rng = np.random.default_rng(11)
    assign = rng.integers(0, K_PARTS, 600).astype(np.int32)
    sec = (assign + rng.integers(1, K_PARTS, 600)) % K_PARTS
    sec = np.where(rng.random(600) < 0.6, sec, -1).astype(np.int32)
    return data, assign, sec


def _np(x):
    """Host copy of a JAX array or a torch tensor; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
            .numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _t(x):
    """A JAX array as a torch tensor (bf16 through its bits)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tables(data, assign, sec, *, metric="cosine", spill=True,
            centroids=None, dtype="f32"):
    jc = JCorpus.from_array(data, metric=metric)
    tc = Corpus.from_array(data, metric=metric, **CPU)
    jt = jps.PartitionTable.build(
        jc, assign, centroids=centroids, secondary=sec if spill else None,
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tt = tps.PartitionTable.build(
        tc, assign, centroids=centroids, secondary=sec if spill else None,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jc, tc, jt, tt


def _carried(jt):
    """The JAX table's arrays as the port's table."""
    return tps.PartitionTable(
        vectors=_t(jt.vectors), v_sq=_t(jt.v_sq), perm=_t(jt.perm),
        starts=_t(jt.starts), lens=_t(jt.lens), centroids=_t(jt.centroids),
        cmax=jt.cmax, k_parts=jt.k_parts)


# ---------------------------------------------------------------------------
# 1. the table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("given_centroids", [False, True])
@pytest.mark.parametrize("spill", [False, True])
def test_partition_table_build_matches(corpora, spill, given_centroids):
    data, assign, sec = corpora
    cents = (np.random.default_rng(2).standard_normal((K_PARTS, 48))
             .astype(np.float32) if given_centroids else None)
    _, _, jt, tt = _tables(data, assign, sec, spill=spill, centroids=cents)
    for name in ("perm", "starts", "lens"):
        np.testing.assert_array_equal(_np(getattr(tt, name)),
                                      _np(getattr(jt, name)))
    assert (tt.cmax, tt.k_parts) == (jt.cmax, jt.k_parts)
    assert tt.vectors.shape[0] == int(tt.lens.sum()) + tt.cmax
    np.testing.assert_array_equal(_np(tt.vectors), _np(jt.vectors))
    # the corpus's squared norms are f32 sums taken in another order
    np.testing.assert_allclose(_np(tt.v_sq), _np(jt.v_sq), rtol=1e-6)
    np.testing.assert_allclose(_np(tt.centroids), _np(jt.centroids),
                               atol=1e-5)
    np.testing.assert_array_equal(tt.partition_sizes(),
                                  jt.partition_sizes())


def test_bf16_table_is_bit_for_bit(corpora):
    data, assign, sec = corpora
    _, _, jt, tt = _tables(data, assign, sec, dtype="bf16")
    assert tt.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tt.vectors), _np(jt.vectors))
    np.testing.assert_allclose(_np(tt.v_sq), _np(jt.v_sq), rtol=1e-6)


def test_default_qcap_matches():
    for b in (1, 7, 64, 100, 1024, 4096):
        for p in (1, 3, 8, 12):
            for kp in (1, 6, 24, 128):
                assert tps.default_qcap(b, p, kp) == \
                    jps.default_qcap(b, p, kp), (b, p, kp)


# ---------------------------------------------------------------------------
# 2. the scans on carried tables
# ---------------------------------------------------------------------------

def _probes(jc, jt, queries, p):
    q = jc.pad_queries(queries)
    mask, ids = jps.probe_mask_from_centroids(q, jt.centroids, num_probes=p,
                                              metric=jc.metric)
    return q, mask, ids


def _same_rows(jd, jr, td, tr, *, bf16, scale=None):
    """scale: for euclidean, 2 max |v|^2; the distances are compared
    squared over it, as tests/test_torch_flat.py does (the square root
    magnifies the cancellation in |q|^2 + |v|^2 - 2 q.v near 0)."""
    jd, jr, td, tr = (_np(x) for x in (jd, jr, td, tr))
    if scale is not None:
        jd = np.where(jd < 1e29, jd ** 2 / scale, jd)
        td = np.where(td < 1e29, td ** 2 / scale, td)
    if not bf16:
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(td, jd, atol=1e-5)
        return
    same = (jr == tr).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(td[same], jd[same], atol=1e-2)


def _scale(data, metric):
    return 2 * float((data * data).sum(1).max()) \
        if metric == "euclidean" else None


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_scan_search_matches(corpora, metric, spill):
    data, assign, sec = corpora
    jc, _, jt, _ = _tables(data, assign, sec, metric=metric, spill=spill)
    tt = _carried(jt)
    q, mask, _ = _probes(jc, jt, data[:40], 2)
    jd, jr = jps.scan_search(jt.vectors, jt.v_sq, jt.perm, jt.starts,
                             jt.lens, mask, q, k=10, cmax=jt.cmax,
                             metric=jc.metric, dedup=spill)
    td, tr = tps.scan_search(tt.vectors, tt.v_sq, tt.perm, tt.starts,
                             tt.lens, _t(mask), _t(q), k=10, cmax=tt.cmax,
                             metric=metric, dedup=spill)
    _same_rows(jd, jr, td, tr, bf16=False, scale=_scale(data, metric))


def test_scan_search_bf16_table_matches(corpora):
    data, assign, sec = corpora
    jc, _, jt, _ = _tables(data, assign, sec, dtype="bf16")
    tt = _carried(jt)
    q, mask, _ = _probes(jc, jt, data[:40], 3)
    jd, jr = jps.scan_search(jt.vectors, jt.v_sq, jt.perm, jt.starts,
                             jt.lens, mask, q, k=10, cmax=jt.cmax,
                             metric=jc.metric, dedup=True)
    td, tr = tps.scan_search(tt.vectors, tt.v_sq, tt.perm, tt.starts,
                             tt.lens, _t(mask), _t(q), k=10, cmax=tt.cmax,
                             metric="cosine", dedup=True)
    _same_rows(jd, jr, td, tr, bf16=True)


def _grouped(jc, jt, tt, q, ids, *, k, qcap, precision):
    jd, jr, jdrop = jps.grouped_search(
        jt.vectors, jt.v_sq, jt.perm, jt.starts, jt.lens, ids, q, k=k,
        cmax=jt.cmax, qcap=qcap, metric=jc.metric, precision=precision)
    td, tr, tdrop = tps.grouped_search(
        tt.vectors, tt.v_sq, tt.perm, tt.starts, tt.lens, _t(ids), _t(q),
        k=k, cmax=tt.cmax, qcap=qcap, metric=jc.metric.value,
        precision=precision)
    assert int(tdrop) == int(jdrop)
    return jd, jr, td, tr, int(tdrop)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_grouped_search_matches(corpora, metric, spill, precision):
    data, assign, sec = corpora
    jc, _, jt, _ = _tables(data, assign, sec, metric=metric, spill=spill)
    tt = _carried(jt)
    q, _, ids = _probes(jc, jt, data[:40], 3)
    qcap = jps.default_qcap(40, 3, K_PARTS)
    jd, jr, td, tr, dropped = _grouped(jc, jt, tt, q, ids, k=10, qcap=qcap,
                                       precision=precision)
    assert dropped == 0
    _same_rows(jd, jr, td, tr, bf16=precision != "highest",
               scale=_scale(data, metric))


def test_grouped_search_drops_pairs_like_the_reference(corpora):
    data, assign, sec = corpora
    jc, _, jt, _ = _tables(data, assign, sec, spill=False)
    tt = _carried(jt)
    q, _, ids = _probes(jc, jt, data[:100], 4)
    jd, jr, td, tr, dropped = _grouped(jc, jt, tt, q, ids, k=10, qcap=8,
                                       precision="highest")
    assert dropped > 0
    _same_rows(jd, jr, td, tr, bf16=False)


def test_grouped_search_pads_when_few_candidates():
    """P * kq < k: clusters of at most 8 rows, 2 probes, k = 20."""
    data = make_clustered(48, 16, k=4, seed=8)
    assign = (np.arange(48) % 8).astype(np.int32)
    jc, _, jt, _ = _tables(data, assign, None, spill=False)
    tt = _carried(jt)
    assert jt.cmax == 8
    q, _, ids = _probes(jc, jt, data[:12], 2)
    jd, jr, td, tr, _ = _grouped(jc, jt, tt, q, ids, k=20, qcap=8,
                                 precision="highest")
    _same_rows(jd, jr, td, tr, bf16=False)
    assert (_np(tr)[:, 16:] == -1).all()


@pytest.mark.parametrize("scan", ["full", "grouped"])
def test_tie_across_two_clusters_keeps_the_reference_order(scan):
    """Rows 3 and 40 hold the same vector, in clusters 2 and 0: the
    sequential merge keeps the earlier cluster's row first, and so does
    the batched one."""
    data = make_clustered(64, 16, k=4, seed=5)
    data[3] = data[40]
    assign = (np.arange(64) % 4).astype(np.int32)
    assign[3], assign[40] = 2, 0
    jc, _, jt, _ = _tables(data, assign, None, spill=False)
    tt = _carried(jt)
    q = jc.pad_queries(data[40:41] + 0.01)
    ids = jnp.asarray([[2, 0, 1, 3]], jnp.int32)
    mask = jnp.ones((1, 4), bool)
    if scan == "full":
        jd, jr = jps.scan_search(jt.vectors, jt.v_sq, jt.perm, jt.starts,
                                 jt.lens, mask, q, k=5, cmax=jt.cmax,
                                 metric=jc.metric)
        td, tr = tps.scan_search(tt.vectors, tt.v_sq, tt.perm, tt.starts,
                                 tt.lens, _t(mask), _t(q), k=5,
                                 cmax=tt.cmax, metric="cosine")
    else:
        jd, jr, td, tr, _ = _grouped(jc, jt, tt, q, ids, k=5, qcap=8,
                                     precision="highest")
    _same_rows(jd, jr, td, tr, bf16=False)
    top2 = _np(tr)[0, :2].tolist()
    assert sorted(top2) == [3, 40] and _np(td)[0, 0] == _np(td)[0, 1]


# ---------------------------------------------------------------------------
# 3. JAX-built indexes carried across
# ---------------------------------------------------------------------------

DATA = make_clustered(1200, 64, k=10, seed=21)      # tests/test_families.py
QUERIES = DATA[:24]
_, EXACT10 = brute_force_knn(DATA, QUERIES, 10, "cosine")


@pytest.fixture(scope="module")
def jax_ivf():
    return hnsw_tpu.build_index(DATA, "ivf_flat", num_partitions=12, spill=1)


@pytest.mark.parametrize("mode", MODES)
def test_carried_ivf_flat_rows_identical(jax_ivf, mode):
    t = convert.from_reference(DATA, jax_ivf.to_state(), metric="cosine",
                               family="ivf_flat", **CPU)
    for scan in ("full", "grouped"):
        jd, jr = jax_ivf.search_batch(QUERIES, 10, mode, scan=scan)
        td, tr = t.search_batch(QUERIES, 10, mode, scan=scan)
        np.testing.assert_array_equal(_np(tr), _np(jr))
        np.testing.assert_allclose(_np(td), _np(jd), atol=1e-5)
        if scan == "grouped":
            assert t.index_info()["last_grouped_dropped_pairs"] == \
                jax_ivf.index_info()["last_grouped_dropped_pairs"]


@pytest.mark.parametrize("use_centroids", [True, False])
def test_carried_lightning_rows_identical(use_centroids):
    """With use_centroids=False both indexes draw their random probes from
    default_rng(seed) in the same call order."""
    j = hnsw_tpu.build_index(DATA, "lightning", num_partitions=12,
                             partitioning="smart", use_centroids=use_centroids,
                             seed=7)
    t = convert.from_reference(DATA, j.to_state(), metric="cosine",
                               family="lightning", **CPU)
    assert t.use_centroids is use_centroids
    for mode in MODES:
        jd, jr = j.search_batch(QUERIES, 10, mode)
        td, tr = t.search_batch(QUERIES, 10, mode)
        np.testing.assert_array_equal(_np(tr), _np(jr))
        np.testing.assert_allclose(_np(td), _np(jd), atol=1e-5)


def test_from_reference_checks_the_table(jax_ivf):
    state = jax_ivf.to_state()
    with pytest.raises(ValueError, match="names row"):
        convert.from_reference(DATA[:600], state, metric="cosine",
                               family="ivf_flat", **CPU)
    bad = {"params": state["params"],
           "arrays": {**state["arrays"],
                      "lens": state["arrays"]["lens"] + 1}}
    with pytest.raises(ValueError, match="do not fit"):
        convert.from_reference(DATA, bad, metric="cosine",
                               family="ivf_flat", **CPU)


# ---------------------------------------------------------------------------
# 4. port-built indexes against the JAX tests' bars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,kw,bar", [
    ("ivf_flat", dict(num_partitions=12), 0.9),
    ("lightning", dict(num_partitions=12), 0.85)])
def test_port_built_clears_the_family_bar(fam, kw, bar):
    idx = ht.build_index(DATA, fam, metric="cosine", **kw, **CPU)
    _, rows = idx.search_batch(QUERIES, 10, mode="precise")
    assert recall_at_k(_np(rows), EXACT10) >= bar
    _, r_turbo = idx.search_batch(QUERIES, 10, mode="turbo")
    assert recall_at_k(_np(rows), EXACT10) >= \
        recall_at_k(_np(r_turbo), EXACT10) - 0.05
    hits = idx.search(DATA[100], 1, mode="precise")
    assert hits and hits[0]["distance"] < 1e-3
    back = type(idx).from_state(idx.corpus, idx.to_state())
    np.testing.assert_array_equal(
        _np(back.search_batch(QUERIES[:4], 5, "balanced")[1]),
        _np(idx.search_batch(QUERIES[:4], 5, "balanced")[1]))


IVF_DATA = generate_vectors(4000, 128, distribution="embedding",
                            num_clusters=24, seed=9)   # tests/test_ivf.py
IVF_QUERIES = IVF_DATA[:100]
_, IVF_EXACT = brute_force_knn(IVF_DATA, IVF_QUERIES, 10, "cosine")


@pytest.fixture(scope="module")
def spilled():
    return build_ivf_flat_index(IVF_DATA, num_partitions=24, spill=1, **CPU)


def test_balanced_assignment_caps_cluster_size():
    idx = build_ivf_flat_index(IVF_DATA, num_partitions=16, balance=1.25,
                               **CPU)
    sizes = idx.table.partition_sizes()
    assert sizes.max() <= int(np.ceil(1.25 * len(IVF_DATA) / 16))
    assert sizes.sum() == len(IVF_DATA)


def test_reference_recall_band(spilled):
    """>= 0.95 recall@10 at 4 probes, >= 0.97 at 8 (tests/test_ivf.py)."""
    _, rows = spilled.search_batch(IVF_QUERIES, 10, num_probes=4)
    assert recall_at_k(_np(rows), IVF_EXACT) >= 0.95
    _, rows = spilled.search_batch(IVF_QUERIES, 10, num_probes=8)
    assert recall_at_k(_np(rows), IVF_EXACT) >= 0.97


def test_grouped_matches_full_scan(spilled):
    _, rf = spilled.search_batch(IVF_QUERIES, 10, num_probes=8, scan="full")
    _, rg = spilled.search_batch(IVF_QUERIES, 10, num_probes=8,
                                 scan="grouped")
    agree = np.mean([
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist())) / 10
        for a, b in zip(_np(rf), _np(rg))])
    assert agree >= 0.97, agree
    assert spilled.index_info()["last_grouped_dropped_pairs"] == 0
    for rows in (_np(rf), _np(rg)):
        for row in rows:
            assert len(set(row.tolist())) == 10


# ---------------------------------------------------------------------------
# 5. reference faults not copied
# ---------------------------------------------------------------------------

class _F32SlabWatch(TorchDispatchMode):
    """Records every op that returns an f32 [>= rows, dim] tensor."""

    def __init__(self, rows, dim):
        super().__init__()
        self.rows, self.dim, self.seen = rows, dim, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32 \
                and out.dim() == 2 and out.shape[1] == self.dim \
                and out.shape[0] >= self.rows:
            self.seen.append(str(func))
        return out


def test_from_state_casts_before_the_gather():
    """The reference's from_state gathers the f32 slab rows and then casts
    (hnsw_tpu/models/ivf_flat.py:133), an f32 copy of the whole table. The
    port casts the corpus first: no op of its load returns an f32 tensor of
    the slab rows (more rows than the corpus: the table has spill), and the
    table is the build's, bit for bit."""
    data = make_clustered(500, 64, k=6, seed=4)
    idx = build_ivf_flat_index(data, num_partitions=8, spill=1,
                               table_dtype="bf16", **CPU)
    state = idx.to_state()
    assert state["params"]["table_dtype"] == "bf16"
    m = int(idx.table.lens.sum())
    assert m > idx.corpus.n_pad
    with _F32SlabWatch(m, idx.corpus.d_pad) as watch:
        back = IVFFlatIndex.from_state(idx.corpus, state)
    assert watch.seen == []
    assert back.table.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(back.table.vectors),
                                  _np(idx.table.vectors))
    np.testing.assert_array_equal(_np(back.table.v_sq), _np(idx.table.v_sq))


def test_bf16_table_with_euclidean_raises():
    """The reference accepts an explicit bf16 table for euclidean
    (hnsw_tpu/models/ivf_flat.py:168), whose exact scan needs f32 slabs;
    the port raises."""
    data = make_clustered(200, 16, k=4, seed=4)
    j = hnsw_tpu.build_index(data, "ivf_flat", num_partitions=4,
                             metric="euclidean", table_dtype="bf16")
    assert j.table.vectors.dtype == jnp.bfloat16
    with pytest.raises(ValueError, match="euclidean"):
        build_ivf_flat_index(data, num_partitions=4, metric="euclidean",
                             table_dtype="bf16", **CPU)
    auto = build_ivf_flat_index(data, num_partitions=4, metric="euclidean",
                                **CPU)
    assert auto.table.vectors.dtype == torch.float32

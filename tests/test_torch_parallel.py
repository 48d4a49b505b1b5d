"""Port of the multi-device layer (hnsw_tpu_torch/parallel/) against the JAX
package's (hnsw_tpu/parallel/), on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py; the
port runs on meshes of virtual CPU entries (make_mesh(n, device="cpu")).
The twins of the eight cases of tests/test_parallel.py feed both packages
the same seeded inputs:
- the row-sharded exact search: rows identical to JAX's and to the port's
  FlatIndex, distances within 1e-5;
- the partition-sharded HNSW search over a JAX-built graph carried across:
  rows identical to JAX's at precise, on meshes of 1, 4 and 8;
- the cluster-sharded IVF scan with spill: rows identical to JAX's and to
  the port's unsharded IVF-FLAT, distances within 1e-5;
- the sharded Lloyd step: centroids within 1e-5 (tests/test_parallel.py's
  bar), assignments identical;
- the sharded build: the same rows, levels and entries; host-built upper
  layers identical; the device-built layer 0 at a mean row-set overlap of
  at least 0.98 against JAX's (tests/test_torch_families.py's bar for
  stacked builds), recall >= 0.9;
- both divisibility errors; make_mesh past the CUDA device count; a mesh of
  1 and of 8 giving identical rows; dryrun_multichip(8) on the CPU; and a
  JAX-built sharded index carried across with its vectors_p / v_sq_p.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hnsw_tpu import parallel as jpar
from hnsw_tpu.models import build_flat_index as j_flat
from hnsw_tpu.models import build_ivf_flat_index as j_ivf
from hnsw_tpu.models import build_partitioned_hnsw as j_partitioned
from hnsw_tpu.ops.kmeans import lloyd as j_lloyd
from hnsw_tpu.parallel.sharded import sharded_lloyd_step as j_lloyd_step
from hnsw_tpu.types import Corpus as JCorpus, Metric as JMetric

from hnsw_tpu_torch import convert
from hnsw_tpu_torch import parallel as tpar
from hnsw_tpu_torch.models import build_flat_index
from hnsw_tpu_torch.ops.kmeans import lloyd
from hnsw_tpu_torch.parallel.sharded import sharded_lloyd_step
from hnsw_tpu_torch.types import Corpus
from tests.conftest import brute_force_knn, make_unit, recall_at_k

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Many small CPU operators: two threads run them as fast as every
    core, and leave the other cores to the test workers sharing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jpar.make_mesh(8)


def tmesh(n):
    return tpar.make_mesh(n, **CPU)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry(data, jidx, family, **extra):
    state = jidx.to_state()
    state["arrays"].update(extra)
    return convert.from_reference(data, state, metric="cosine",
                                  family=family, **CPU)


# ---------------------------------------------------------------------------
# the indexes, built once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_case(jmesh8):
    data = make_unit(500, 64, seed=13)
    q = data[:16]
    jd, jr = jpar.ShardedFlatIndex(j_flat(data).corpus, jmesh8) \
        .search_batch(q, 10)
    return data, q, _np(jd), _np(jr)


@pytest.fixture(scope="module")
def partitioned_case(jmesh8):
    data = make_unit(800, 48, seed=17)
    jidx = j_partitioned(data, num_partitions=8, M=8)
    q = data[:16]
    jd, jr = jpar.ShardedPartitionedHNSW(jidx, jmesh8).search_batch(
        q, 10, mode="precise")
    return data, q, _carry(data, jidx, "partitioned_hnsw"), _np(jd), _np(jr)


@pytest.fixture(scope="module")
def ivf_case(jmesh8):
    data = make_unit(900, 48, seed=29)
    jidx = j_ivf(data, num_partitions=24, spill=1)
    q = data[:16]
    jd, jr = jpar.ShardedIVFFlat(jidx, jmesh8).search_batch(
        q, 10, mode="accurate")
    return data, q, _carry(data, jidx, "ivf_flat"), _np(jd), _np(jr)


@pytest.fixture(scope="module")
def build_case(jmesh8):
    data = make_unit(1200, 48, seed=23)
    jidx = jpar.build_partitioned_hnsw_sharded(data, num_partitions=8,
                                               mesh=jmesh8, M=8)
    tidx = tpar.build_partitioned_hnsw_sharded(data, num_partitions=8,
                                               mesh=tmesh(8), M=8)
    return data, jidx, tidx


# ---------------------------------------------------------------------------
# searches
# ---------------------------------------------------------------------------

def test_sharded_exact_matches_single_device(flat_case):
    data, q, jd, jr = flat_case
    corpus = build_flat_index(data, **CPU).corpus
    d1, r1 = build_flat_index(data, **CPU).search_batch(q, 10)
    d2, r2 = tpar.ShardedFlatIndex(corpus, tmesh(8)).search_batch(q, 10)
    np.testing.assert_array_equal(_np(r2), jr)
    np.testing.assert_array_equal(_np(r2), _np(r1))
    np.testing.assert_allclose(_np(d2), jd, atol=1e-5)
    np.testing.assert_allclose(_np(d2), _np(d1), atol=1e-5)


def test_sharded_exact_topk_takes_pieces_or_tensors(flat_case):
    """sharded_exact_topk splits a tensor itself or takes its pieces."""
    data, q, _, jr = flat_case
    flat = tpar.ShardedFlatIndex(build_flat_index(data, **CPU).corpus,
                                 tmesh(4))
    whole = [torch.cat(x) for x in (flat.vectors, flat.v_sq, flat.rows)]
    qp = flat.corpus.pad_queries(q)
    _, r_pieces = tpar.sharded_exact_topk(
        flat.mesh, flat.vectors, flat.v_sq, flat.rows, qp, k=10,
        metric="cosine")
    _, r_whole = tpar.sharded_exact_topk(flat.mesh, *whole, qp, k=10,
                                         metric="cosine")
    np.testing.assert_array_equal(_np(r_pieces), jr)
    np.testing.assert_array_equal(_np(r_whole), jr)


@pytest.mark.parametrize("n_mesh", [1, 4, 8])
def test_sharded_partitioned_hnsw(partitioned_case, n_mesh):
    """A mesh of 8 is tests/test_parallel.py's case; 4 and 1 are the port's
    twin of test_mesh_smaller_than_devices over the same 8 partitions."""
    data, q, tidx, jd, jr = partitioned_case
    d, r = tpar.ShardedPartitionedHNSW(tidx, tmesh(n_mesh)).search_batch(
        q, 10, mode="precise")
    np.testing.assert_array_equal(_np(r), jr)
    np.testing.assert_allclose(_np(d), jd, atol=1e-5)
    _, exact = brute_force_knn(data, q, 10, "cosine")
    assert recall_at_k(_np(r), exact) >= 0.9


def test_mesh_smaller_than_devices(jmesh8):
    data = make_unit(200, 32, seed=19)
    jidx = j_partitioned(data, num_partitions=4, M=4)
    _, jr = jpar.ShardedPartitionedHNSW(jidx, jpar.make_mesh(4)) \
        .search_batch(data[:4], 5, mode="precise")
    tidx = _carry(data, jidx, "partitioned_hnsw")
    _, r = tpar.ShardedPartitionedHNSW(tidx, tmesh(4)).search_batch(
        data[:4], 5, mode="precise")
    np.testing.assert_array_equal(_np(r), _np(jr))
    assert int(r[0, 0]) == 0  # self found


def test_sharded_ivf_matches_unsharded(ivf_case):
    data, q, tidx, jd, jr = ivf_case
    d1, r1 = tidx.search_batch(q, 10, mode="accurate")
    d2, r2 = tpar.ShardedIVFFlat(tidx, tmesh(8)).search_batch(
        q, 10, mode="accurate")
    np.testing.assert_array_equal(_np(r2), jr)
    np.testing.assert_array_equal(_np(r2), _np(r1))
    np.testing.assert_allclose(_np(d2), jd, atol=1e-5)
    np.testing.assert_allclose(_np(d2), _np(d1), atol=1e-5)


@pytest.mark.parametrize("family", ["flat", "ivf_flat", "partitioned_hnsw"])
def test_mesh_of_one_and_of_eight_give_identical_rows(flat_case, ivf_case,
                                                      partitioned_case,
                                                      family):
    if family == "flat":
        data, q = flat_case[:2]
        corpus = build_flat_index(data, **CPU).corpus
        make = lambda m: tpar.ShardedFlatIndex(corpus, m)  # noqa: E731
        mode = "balanced"
    else:
        data, q, tidx = (ivf_case if family == "ivf_flat"
                         else partitioned_case)[:3]
        cls = (tpar.ShardedIVFFlat if family == "ivf_flat"
               else tpar.ShardedPartitionedHNSW)
        make = lambda m: cls(tidx, m)  # noqa: E731
        mode = "precise"
    d1, r1 = make(tmesh(1)).search_batch(q, 10, mode)
    d8, r8 = make(tmesh(8)).search_batch(q, 10, mode)
    np.testing.assert_array_equal(_np(r1), _np(r8))
    np.testing.assert_allclose(_np(d1), _np(d8), atol=1e-5)


def test_k_past_the_candidates_pads_with_minus_one():
    """Fewer candidates than k: the reference pads (1e30, -1)."""
    data = make_unit(12, 16, seed=5)
    corpus = build_flat_index(data, **CPU).corpus
    d, r = tpar.ShardedFlatIndex(corpus, tmesh(2)).search_batch(data[:2], 40)
    assert r.shape == (2, 40)
    assert (_np(r)[:, 16:] == -1).all() and (_np(d)[:, 16:] == 1e30).all()
    assert sorted(_np(r)[0, :12].tolist()) == list(range(12))


# ---------------------------------------------------------------------------
# the Lloyd step
# ---------------------------------------------------------------------------

def test_sharded_lloyd_matches_single_device(jmesh8):
    data = make_unit(256, 32, seed=41)
    jc = JCorpus.from_array(data)
    cents0 = jc.vectors[:8]
    valid = jnp.arange(jc.n_pad) < jc.n
    shard = NamedSharding(jmesh8, P("shards"))
    j_cents, j_assign = j_lloyd_step(
        jmesh8, jax.device_put(jc.vectors, shard),
        jax.device_put(jc.sq_norms, shard),
        jax.device_put(valid.astype(jnp.float32), shard), cents0,
        metric=JMetric.COSINE)
    j_cents1, _ = j_lloyd(jc.vectors, jc.sq_norms, valid, cents0, iters=1,
                          metric=JMetric.COSINE)

    tc = Corpus.from_array(data, **CPU)
    tvalid = torch.arange(tc.n_pad) < tc.n
    cents, assign = sharded_lloyd_step(
        tmesh(8), tc.vectors, tc.sq_norms, tvalid.float(), tc.vectors[:8],
        metric="cosine")
    np.testing.assert_allclose(_np(cents), _np(j_cents), atol=1e-5)
    np.testing.assert_allclose(_np(cents), _np(j_cents1), atol=1e-5)
    assert len(assign) == 8
    np.testing.assert_array_equal(torch.cat(assign).numpy(), _np(j_assign))
    # the assignments of the step are the single-device ones
    _, single = lloyd(tc.vectors, tc.sq_norms, tvalid, tc.vectors[:8],
                      iters=0, metric="cosine")
    np.testing.assert_array_equal(torch.cat(assign).numpy(), _np(single))


# ---------------------------------------------------------------------------
# the sharded build
# ---------------------------------------------------------------------------

def _overlap(a, b):
    ov = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
          / max(len(set(y[y >= 0].tolist())), 1) for x, y in zip(a, b)]
    return float(np.mean(ov))


def test_sharded_partitioned_build(build_case):
    data, jidx, tidx = build_case
    for name in ("rows_p", "entries_p"):
        np.testing.assert_array_equal(_np(getattr(tidx, name)),
                                      _np(getattr(jidx, name)))
    np.testing.assert_array_equal(_np(tidx.vectors_p), _np(jidx.vectors_p))
    np.testing.assert_allclose(_np(tidx.v_sq_p), _np(jidx.v_sq_p),
                               rtol=1e-6)
    # every upper layer here has at most HOST_LAYER_MAX members: numpy on
    # both sides, identical adjacency
    assert tidx.adj_upper_p.shape[1] >= 1
    np.testing.assert_array_equal(_np(tidx.adj_upper_p),
                                  _np(jidx.adj_upper_p))
    # layer 0 runs _layer_fused on the device side of each package
    live = _np(jidx.rows_p) >= 0
    assert _overlap(_np(tidx.adj0_p)[live], _np(jidx.adj0_p)[live]) >= 0.98

    q = data[:16]
    _, exact = brute_force_knn(data, q, 10, "cosine")
    _, r = tidx.search_batch(q, 10, mode="precise")
    assert recall_at_k(_np(r), exact) >= 0.9
    _, r2 = tpar.ShardedPartitionedHNSW(tidx, tmesh(8)).search_batch(
        q, 10, mode="precise")
    assert recall_at_k(_np(r2), exact) >= 0.9


def test_sharded_build_carried_across_searches_to_identical_rows(
        build_case, jmesh8):
    """A JAX index built by build_partitioned_hnsw_sharded carries across
    with its vectors_p / v_sq_p (convert.from_reference) and returns JAX's
    rows, sharded and single-device."""
    data, jidx, _ = build_case
    tidx = _carry(data, jidx, "partitioned_hnsw",
                  vectors_p=np.asarray(jidx.vectors_p),
                  v_sq_p=np.asarray(jidx.v_sq_p))
    np.testing.assert_array_equal(_np(tidx.vectors_p), _np(jidx.vectors_p))
    np.testing.assert_array_equal(_np(tidx.v_sq_p), _np(jidx.v_sq_p))
    q = data[:16]
    jd, jr = jpar.ShardedPartitionedHNSW(jidx, jmesh8).search_batch(
        q, 10, mode="precise")
    d, r = tpar.ShardedPartitionedHNSW(tidx, tmesh(8)).search_batch(
        q, 10, mode="precise")
    np.testing.assert_array_equal(_np(r), _np(jr))
    np.testing.assert_allclose(_np(d), _np(jd), atol=1e-5)
    jd, jr = jidx.search_batch(q, 10, mode="precise")
    d, r = tidx.search_batch(q, 10, mode="precise")
    np.testing.assert_array_equal(_np(r), _np(jr))


def test_carried_vectors_p_of_the_wrong_shape_raise(build_case):
    data, jidx, _ = build_case
    with pytest.raises(ValueError):
        _carry(data, jidx, "partitioned_hnsw",
               vectors_p=np.asarray(jidx.vectors_p)[:, :, :64],
               v_sq_p=np.asarray(jidx.v_sq_p))


# ---------------------------------------------------------------------------
# errors, meshes, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["search", "build"])
def test_partition_divisibility_errors(path):
    from hnsw_tpu_torch.models import build_partitioned_hnsw
    data = make_unit(100, 32)
    if path == "search":
        idx = build_partitioned_hnsw(data, num_partitions=3, M=4, **CPU)
        with pytest.raises(ValueError):
            tpar.ShardedPartitionedHNSW(idx, tmesh(8))
    else:
        with pytest.raises(ValueError):
            tpar.build_partitioned_hnsw_sharded(data, num_partitions=3,
                                                mesh=tmesh(8))


def test_make_mesh_past_the_cuda_device_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError):
        tpar.make_mesh(2, device="cuda")
    assert tpar.make_mesh(device="cuda").device_list == [
        torch.device("cuda", 0)]
    # one named device gives virtual entries: the card's mesh of four
    virtual = tpar.make_mesh(4, device="cuda:0")
    assert virtual.device_list == [torch.device("cuda", 0)] * 4
    assert tpar.Mesh(["cuda:0"] * 4).device_list == virtual.device_list


def test_shard_raises_when_dim0_does_not_divide():
    from hnsw_tpu_torch.parallel.mesh import shard
    with pytest.raises(ValueError):
        shard(tmesh(4), torch.zeros(6, 2))


def test_dryrun_multichip_on_eight_cpu_entries():
    from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, **CPU)

"""The port's public surface against the JAX package's, on the CPU.

1. Every public name each module of hnsw_tpu/ defines (an AST walk) is
   defined by the module of the same path under hnsw_tpu_torch/, and every
   name a package's __all__ exports exists in its twin. The kernel modules
   ops/pallas_hop.py and ops/pallas_scan.py have their twins under other
   names (ops/hop.py, ops/scan.py, held by the kernel tests), and
   utils/cache.py (JAX's compile-cache scrub) has none; nor have
   utils/timing.py (Timer, timed) and utils/profiling.py's annotate, which
   the port's one tracer, utils/tracing.py, replaces.
2. mask_invalid, heuristic_select and build_layer give JAX's results (the
   device path of build_layer at the 0.98 row-set overlap of the stacked
   builds, tests/test_torch_families.py).
3. PCAFIndex takes the reference's low_vectors / low_sq keywords.
4. scan_search takes the reference's positional order (starts before lens,
   cmax), gives JAX's rows, and raises on a starts or cmax that does not
   fit the slabs.
5. The entry points of __graft_entry__.py, entry and dryrun_multichip,
   have their twins: hnsw_tpu_torch/entry.py and parallel/dryrun.py.
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.models import _partition_scan as jps
from hnsw_tpu.models.hnsw import build as jbuild
from hnsw_tpu.models.pcaf import build_pcaf_index as j_pcaf
from hnsw_tpu.ops import topk as jtopk
from hnsw_tpu.types import Corpus as JCorpus, Metric as JMetric

from hnsw_tpu_torch.models import _partition_scan as tps
from hnsw_tpu_torch.models.hnsw import build as tbuild
from hnsw_tpu_torch.models.pcaf import PCAFIndex, build_pcaf_index
from hnsw_tpu_torch.ops import topk as ttopk
from hnsw_tpu_torch.types import Corpus
from tests.conftest import make_clustered, make_unit

CPU = dict(device="cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_SAME_PATH_TWIN = {"ops/pallas_hop.py", "ops/pallas_scan.py",
                     "utils/cache.py", "utils/timing.py"}
# public names with no twin: utils/tracing.py takes their place
NO_TWIN = {"annotate", "Timer", "timed"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _defined(path: pathlib.Path) -> set:
    """Public names a module defines at its top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _modules():
    ref = ROOT / "hnsw_tpu"
    return sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py"))


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_twin(rel):
    twin = ROOT / "hnsw_tpu_torch" / rel
    if rel in NO_SAME_PATH_TWIN:
        assert not twin.exists()
        return
    gap = _defined(ROOT / "hnsw_tpu" / rel) - _defined(twin) - NO_TWIN
    assert not gap, f"{rel}: no twin for {sorted(gap)}"


@pytest.mark.parametrize("pkg", ["", ".ops", ".models", ".io", ".parallel",
                                 ".utils", ".bench"])
def test_every_exported_name_exists(pkg):
    ref = importlib.import_module("hnsw_tpu" + pkg)
    port = importlib.import_module("hnsw_tpu_torch" + pkg)
    missing = [n for n in ref.__all__
               if not hasattr(port, n) and n not in NO_TWIN]
    assert not missing, f"hnsw_tpu_torch{pkg} lacks {missing}"


def test_graft_entry_points_have_twins():
    hooks = _defined(ROOT / "__graft_entry__.py")
    twins = {"entry": "entry.py", "dryrun_multichip": "parallel/dryrun.py"}
    assert hooks == set(twins)
    for name, rel in twins.items():
        assert name in _defined(ROOT / "hnsw_tpu_torch" / rel), rel
        module = "hnsw_tpu_torch." + rel[:-3].replace("/", ".")
        assert callable(getattr(importlib.import_module(module), name))


def test_mask_invalid_matches():
    r = np.random.default_rng(0)
    d = r.standard_normal((4, 9)).astype(np.float32)
    ok = r.random((4, 9)) < 0.6
    want = np.asarray(jtopk.mask_invalid(jnp.asarray(d), jnp.asarray(ok)))
    got = ttopk.mask_invalid(torch.from_numpy(d), torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), want)


def test_heuristic_select_matches():
    """Exact candidate lists of 64 nodes (ascending, the heuristic's input)
    and their pairwise distances."""
    x = make_clustered(300, 32, seed=3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    dist = 1.0 - x @ x.T
    np.fill_diagonal(dist, np.inf)
    cand = np.argsort(dist, axis=1, kind="stable")[:64, :24].astype(np.int32)
    cand[5, 20:] = -1                                  # a short list
    cd = np.take_along_axis(dist[:64], np.maximum(cand, 0), axis=1)
    cd = np.where(cand >= 0, cd, 1e30).astype(np.float32)
    c = np.maximum(cand, 0)
    pair = dist[c[:, :, None], c[:, None, :]].astype(np.float32)
    pair[~np.isfinite(pair)] = 0.0
    for keep in (True, False):
        want = jbuild.heuristic_select(jnp.asarray(cand), jnp.asarray(cd),
                                       jnp.asarray(pair), cap=8,
                                       keep_pruned=keep)
        got = tbuild.heuristic_select(torch.from_numpy(cand),
                                      torch.from_numpy(cd),
                                      torch.from_numpy(pair), cap=8,
                                      keep_pruned=keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _overlap(a, b):
    ov = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
          / max(len(set(y[y >= 0].tolist())), 1) for x, y in zip(a, b)]
    return float(np.mean(ov))


@pytest.mark.parametrize("path,size", [("host", 300), ("device", 700),
                                       ("one", 1)])
def test_build_layer_matches(path, size):
    data = make_clustered(900, 32, seed=7)
    jc = JCorpus.from_array(data)
    tc = Corpus.from_array(data, **CPU)
    rows = np.sort(np.random.default_rng(2).permutation(900)[:size]) \
        .astype(np.int32)
    kw = dict(cap=12, k_cand=24)
    want = jbuild.build_layer(jc.vectors, jc.sq_norms, rows,
                              metric=JMetric("cosine"), **kw)
    got = tbuild.build_layer(tc.vectors, tc.sq_norms, rows, metric="cosine",
                             **kw)
    assert got.shape == want.shape == (size, 12)
    if path == "device":
        assert _overlap(got, want) >= 0.98
    else:
        np.testing.assert_array_equal(got, want)


def test_pcaf_takes_low_vectors_and_low_sq():
    data = make_unit(400, 48, seed=9)
    j = j_pcaf(data, n_components=16)
    built = build_pcaf_index(data, n_components=16, **CPU)
    low = torch.matmul(built.corpus.vectors, built.proj)
    given = PCAFIndex(built.corpus, proj=built.proj, low_vectors=low,
                      low_sq=torch.sum(low * low, dim=-1), n_components=16)
    assert given.low_vectors is low
    q = data[:20]
    _, want = built.search_batch(q, 10)
    _, got = given.search_batch(q, 10)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the JAX index's own projected corpus, passed the reference's way
    carried = PCAFIndex(
        built.corpus, proj=torch.tensor(np.asarray(j.proj)),
        low_vectors=torch.tensor(np.asarray(j.low_vectors)),
        low_sq=torch.tensor(np.asarray(j.low_sq)), n_components=16)
    _, jr = j.search_batch(q, 10)
    np.testing.assert_array_equal(carried.search_batch(q, 10)[1].numpy(),
                                  np.asarray(jr))


@pytest.fixture(scope="module")
def table():
    """A spilled JAX table and its arrays as the port's."""
    data = make_clustered(300, 32, k=6, seed=4)
    jc = JCorpus.from_array(data)
    assign = (np.arange(300) % 5).astype(np.int32)
    sec = np.where(np.arange(300) % 3 == 0, (assign + 1) % 5, -1) \
        .astype(np.int32)
    jt = jps.PartitionTable.build(jc, assign, secondary=sec)
    t = {name: torch.tensor(np.asarray(getattr(jt, name)))
         for name in ("vectors", "v_sq", "perm", "starts", "lens",
                      "centroids")}
    q = jc.pad_queries(data[:12])
    mask, _ = jps.probe_mask_from_centroids(q, jt.centroids, num_probes=2,
                                            metric=jc.metric)
    return jc, jt, t, q, mask


def test_scan_search_takes_the_reference_positional_order(table):
    jc, jt, t, q, mask = table
    args = (t["vectors"], t["v_sq"], t["perm"], t["starts"], t["lens"],
            torch.tensor(np.asarray(mask)), torch.tensor(np.asarray(q)))
    jd, jr = jps.scan_search(jt.vectors, jt.v_sq, jt.perm, jt.starts,
                             jt.lens, mask, q, k=10, cmax=jt.cmax,
                             metric=jc.metric, dedup=True)
    td, tr = tps.scan_search(*args, k=10, cmax=jt.cmax, metric="cosine",
                             dedup=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


@pytest.mark.parametrize("fault", ["starts", "cmax", "lens_for_starts"])
def test_scan_search_rejects_slabs_that_do_not_fit(table, fault):
    jc, jt, t, q, mask = table
    starts, lens, cmax = t["starts"], t["lens"], jt.cmax
    if fault == "starts":
        starts = starts.clone()
        starts[2] += 1
    elif fault == "cmax":
        cmax = int(lens.max()) - 1
    else:                  # the port's old order: lens where starts goes
        starts = lens
    with pytest.raises(ValueError):
        tps.scan_search(t["vectors"], t["v_sq"], t["perm"], starts, lens,
                        torch.tensor(np.asarray(mask)),
                        torch.tensor(np.asarray(q)), k=10, cmax=cmax,
                        metric="cosine", dedup=True)

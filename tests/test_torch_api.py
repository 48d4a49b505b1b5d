"""Port of the unified and stateful APIs and of persistence
(hnsw_tpu_torch/api, hnsw_tpu_torch/io/persist.py) against the JAX
package, on the CPU.

1. The lifecycle cases of tests/test_api.py for the ported families (flat,
   hnsw): dispatch by name and alias, search, batch and filtered search,
   info, capability predicates, the stateful Index with string ids,
   metadata, a wave insert on its second flush, and save / load.
2. Cross-package persistence, both ways, in both on-disk formats (.npz and
   the .idx directory): an index saved by one package loads in the other
   with the same header, arrays, ids and metadata, and answers with
   identical rows.
3. Names: the five names of the families ported last (IVF-FLAT, Lightning,
   LSH and PCAF, with the alias lsh) build through build_index as the
   JAX package's index of that name, and cross-package .npz persistence
   both ways for those four families.
4. A reference fault not copied (ROADMAP §C): build_best_for_size lets a
   caller's precision= win where the reference raises TypeError.
"""

import numpy as np
import pytest
import torch

import hnsw_tpu

import hnsw_tpu_torch as ht
from hnsw_tpu_torch.io import persist
from hnsw_tpu_torch.types import Corpus
from tests.conftest import make_unit

DATA = make_unit(300, 32, seed=31)
IDS = [f"v{i}" for i in range(300)]
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["flat", "brute_force", "hnsw", "ultra-fast",
                                  ":pure_hnsw"])
def test_build_index_dispatch_and_aliases(kind):
    idx = ht.build_index(DATA, kind, M=8, **CPU)
    assert ht.index_type(idx) == ("flat" if "flat" in kind or "brute" in kind
                                  else "hnsw")
    assert ht.index_info(idx)["type"] == idx.family
    hits = ht.search_knn(idx, DATA[0], 5)
    assert hits[0]["id"] == 0 and hits[0]["distance"] < 1e-3
    res = ht.batch_search_knn(idx, DATA[:5], 3)
    assert [r[0]["id"] for r in res] == list(range(5))
    assert all(len(r) == 3 for r in res)
    assert ht.api.supports_batch(idx) and ht.api.supports_filter(idx) \
        and ht.api.supports_persistence(idx)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown index type"):
        ht.build_index(DATA, "nope", **CPU)


@pytest.mark.parametrize("kind", ["lightning", "ivf_flat", "lsh",
                                  "hybrid_lsh", "pcaf"])
def test_late_families_build_as_the_reference_names_them(kind):
    assert kind in hnsw_tpu.FAMILIES and kind in ht.FAMILIES
    j = hnsw_tpu.build_index(DATA, kind)
    t = ht.build_index(DATA, kind, **CPU)
    assert (t.family, t.index_type, ht.index_info(t)["type"]) == \
        (j.family, j.index_type, hnsw_tpu.index_info(j)["type"])
    assert type(t) is ht.models.INDEX_CLASSES[j.family]
    hits = ht.search_knn(t, DATA[0], 5, mode="precise")
    assert len(hits) == 5 and hits[0]["distance"] < 1e-3


def test_build_best_for_size_both_policies():
    idx = ht.build_best_for_size(DATA, **CPU)
    assert (idx.family, idx.precision, idx.int8_fetch) == ("flat", "int8", 0)
    _, r = idx.search_batch(DATA[:4], 3)
    assert (r.numpy()[:, 0] == np.arange(4)).all()
    assert ht.build_best_for_size(DATA, policy="reference", M=8,
                                  **CPU).family == "hnsw"   # < 1000 rows
    mid = make_unit(1000, 8, seed=3)          # < 10k rows: partitioned HNSW
    assert ht.build_best_for_size(mid, policy="reference", M=8,
                                  **CPU).family == "partitioned_hnsw"
    big = make_unit(10000, 4, seed=3)         # >= 10k rows: IVF-FLAT
    assert ht.build_best_for_size(big, policy="reference",
                                  **CPU).family == "ivf_flat"


def test_build_best_for_size_lets_precision_win():
    """Deliberate divergence (ROADMAP §C): the reference passes
    precision="int8" and **opts to one call, so a caller's precision raises
    TypeError there; the port merges them and the caller's value wins."""
    with pytest.raises(TypeError, match="precision"):
        hnsw_tpu.build_best_for_size(DATA, precision="bf16")
    idx = ht.build_best_for_size(DATA, precision="bf16", **CPU)
    assert (idx.precision, idx.int8_fetch) == ("bf16", 0)


def test_filtered_search():
    idx = ht.build_index(DATA, "flat", ids=IDS, **CPU)
    hits = ht.filtered_search_knn(idx, DATA[0], 5,
                                  lambda i: int(i[1:]) >= 100)
    assert len(hits) == 5 and all(int(h["id"][1:]) >= 100 for h in hits)


@pytest.mark.parametrize("index_type", ["hnsw", "flat"])
def test_simple_index_lifecycle(tmp_path, index_type):
    ix = ht.Index(dimensions=32, distance="cosine", index_type=index_type,
                  M=8, **CPU)
    for i in range(100):
        ix.add(f"doc{i}", DATA[i], metadata={"n": i})
    hits = ix.search(DATA[7], 3)
    assert hits[0]["id"] == "doc7" and hits[0]["metadata"] == {"n": 7}
    assert ix.size == 100

    # adds after the first build: a wave insert (hnsw) or a rebuild (flat)
    ix.add_batch([(f"doc{i}", DATA[i]) for i in range(100, 140)])
    hits = ix.search(DATA[120], 1)
    assert hits[0]["id"] == "doc120"
    assert ix.size == 140 and ix.info()["index_type"] == index_type

    for fmt in ("npz", "dir"):
        p = ix.save(str(tmp_path / f"simple_{fmt}"), format=fmt)
        assert ht.index_exists(p)
        ix2 = ht.Index.load(p, **CPU)
        h1 = [h["id"] for h in ix.search(DATA[3], 5)]
        h2 = [h["id"] for h in ix2.search(DATA[3], 5)]
        assert h1 == h2
        assert ix2.search(DATA[9], 1)[0]["metadata"] == {"n": 9}
        # a loaded index grows on the device it was loaded onto
        ix2.add("late", DATA[200])
        assert ix2.search(DATA[200], 1)[0]["id"] == "late"


def test_simple_dim_mismatch_and_empty():
    ix = ht.Index(dimensions=32, **CPU)
    with pytest.raises(ValueError):
        ix.add("a", np.zeros(16, np.float32))
    assert ht.Index(dimensions=8, **CPU).search(np.zeros(8, np.float32)) == []
    with pytest.raises(ValueError, match="empty"):
        ht.Index(dimensions=8, **CPU).save("nowhere")


# ---------------------------------------------------------------------------
# cross-package persistence
# ---------------------------------------------------------------------------

FAMILY_OPTS = {
    "flat": dict(precision="int8", scan_kernel="packed", int8_fetch=0),
    "hnsw": dict(M=8),
}


def _rows(idx, queries):
    d, r = idx.search_batch(queries, 5)
    return np.asarray(r.numpy() if hasattr(r, "numpy") else r)


@pytest.mark.parametrize("fmt", ["npz", "dir"])
@pytest.mark.parametrize("family", ["flat", "hnsw"])
def test_jax_save_loads_in_the_port(tmp_path, family, fmt):
    j = hnsw_tpu.build_index(DATA, family, ids=IDS, **FAMILY_OPTS[family])
    p = hnsw_tpu.save_index(j, str(tmp_path / "jax"), format=fmt,
                            metadata={"v3": {"tag": "x"}})
    t, meta = ht.load_index(p, return_metadata=True, **CPU)
    assert meta == {"v3": {"tag": "x"}}
    assert (t.family, t.corpus.metric.value, t.corpus.n) == \
        (family, "cosine", 300)
    assert list(t.corpus.ids) == IDS
    np.testing.assert_array_equal(t.corpus.vectors.numpy(),
                                  np.asarray(j.corpus.vectors))
    assert t.to_state()["params"] == j.to_state()["params"]
    for name, arr in j.to_state()["arrays"].items():
        np.testing.assert_array_equal(t.to_state()["arrays"][name], arr)
    q = DATA[:40]
    np.testing.assert_array_equal(_rows(t, q), _rows(j, q))


@pytest.mark.parametrize("fmt", ["npz", "dir"])
@pytest.mark.parametrize("family", ["flat", "hnsw"])
def test_port_save_loads_in_jax(tmp_path, family, fmt):
    t = ht.build_index(DATA, family, ids=IDS, **FAMILY_OPTS[family], **CPU)
    p = ht.save_index(t, str(tmp_path / "port"), format=fmt,
                      metadata={"v3": {"tag": "x"}})
    j, meta = hnsw_tpu.load_index(p, return_metadata=True)
    assert meta == {"v3": {"tag": "x"}}
    assert (j.family, j.corpus.metric.value, j.corpus.n) == \
        (family, "cosine", 300)
    assert list(j.corpus.ids) == IDS
    np.testing.assert_array_equal(np.asarray(j.corpus.vectors),
                                  t.corpus.vectors.numpy())
    assert j.to_state()["params"] == t.to_state()["params"]
    for name, arr in t.to_state()["arrays"].items():
        np.testing.assert_array_equal(np.asarray(j.to_state()["arrays"][name]),
                                      arr)
    q = DATA[:40]
    np.testing.assert_array_equal(_rows(j, q), _rows(t, q))


LATE_OPTS = {
    "ivf_flat": dict(num_partitions=6, spill=1),
    "lightning": dict(num_partitions=6, use_centroids=False),
    "hybrid_lsh": dict(num_bits=6),
    "pcaf": dict(n_components=16),
}


@pytest.mark.parametrize("family", list(LATE_OPTS))
def test_late_families_persist_across_packages(tmp_path, family):
    """.npz both ways: the JAX package's file loads in the port and the
    port's in the JAX package, with equal params and arrays and identical
    rows (Lightning's random probes from the same seed and call order)."""
    q = DATA[:40]
    j = hnsw_tpu.build_index(DATA, family, ids=IDS, **LATE_OPTS[family])
    t = ht.load_index(hnsw_tpu.save_index(j, str(tmp_path / "jax")), **CPU)
    t2 = ht.build_index(DATA, family, ids=IDS, **LATE_OPTS[family], **CPU)
    j2 = hnsw_tpu.load_index(ht.save_index(t2, str(tmp_path / "port")))
    for a, b in ((t, j), (j2, t2)):
        assert type(a).__name__ == type(b).__name__
        assert list(a.corpus.ids) == IDS
        assert a.to_state()["params"] == b.to_state()["params"]
        for name, arr in b.to_state()["arrays"].items():
            np.testing.assert_array_equal(
                np.asarray(a.to_state()["arrays"][name]), np.asarray(arr))
        np.testing.assert_array_equal(_rows(a, q), _rows(b, q))


def test_dir_load_streams_in_chunks(tmp_path):
    """A .idx load below stream_chunk_rows packs the corpus chunk by chunk
    (Corpus.from_array_streamed) into the same layout as from_array."""
    t = ht.build_index(DATA, "hnsw", M=8, **CPU)
    p = ht.save_index(t, str(tmp_path / "big"), format="dir")
    back = persist.load_index(p, stream_chunk_rows=64, **CPU)
    np.testing.assert_array_equal(back.corpus.vectors.numpy(),
                                  t.corpus.vectors.numpy())
    np.testing.assert_array_equal(back.graph.adj0.numpy(),
                                  t.graph.adj0.numpy())
    np.testing.assert_array_equal(_rows(back, DATA[:20]),
                                  _rows(t, DATA[:20]))


def test_streamed_corpus_matches_reference():
    from hnsw_tpu.types import Corpus as JCorpus
    data = make_unit(203, 40, seed=4)
    want = JCorpus.from_array_streamed(data, metric="dot", chunk_rows=50)
    got = Corpus.from_array_streamed(data, metric="dot", chunk_rows=50,
                                     device="cpu")
    np.testing.assert_array_equal(got.vectors.numpy(),
                                  np.asarray(want.vectors))
    np.testing.assert_allclose(got.sq_norms.numpy(),
                               np.asarray(want.sq_norms), rtol=1e-6)
    assert (got.n, got.dim, got.metric.value) == (203, 40, "dot")


def test_load_defaults_to_the_card_and_refuses_newer_formats(tmp_path):
    t = ht.build_index(DATA, "flat", **CPU)
    p = ht.save_index(t, str(tmp_path / "f"))
    if torch.cuda.is_available():
        assert ht.load_index(p).corpus.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.load_index(p)
    d = ht.save_index(t, str(tmp_path / "g"), format="dir")
    import json
    import os
    with open(os.path.join(d, "header.json")) as f:
        header = json.load(f)
    header["format_version"] = persist.FORMAT_VERSION + 1
    with open(os.path.join(d, "header.json"), "w") as f:
        json.dump(header, f)
    with pytest.raises(ValueError, match="newer"):
        ht.load_index(d, **CPU)

"""The route of the glove-100-angular deployment (800,000 x 100, cosine) on
the CPU, at a small glove-shaped size; no JAX.

A 6,000 x 100 cosine index built through build_hnsw_index with LARGE_N
lowered so that layers 0-2 take the clustered builder (as 800,000 rows do
with LARGE_N as shipped), searched through HNSWIndex.search_batch with the
pack cap lowered between the int8 and the bf16 pack's bytes (as 6.66 GB of
bf16 pack against 6 GiB are at full size), so that "auto" picks the int8
pack:

1. the route is int8, and hnsw.pack records its precision and bytes;
2. the answers, judged by the benchmark's plain float64 reference, are
   valid, their distances the exact ones within 4e-6 and their recall@10
   at least 0.95;
3. with device tracing on and the card's fixed-length loop forced, the
   dequant phase reads > 0 on the int8 route and 0 on the bf16 and f32
   routes, whose six search phases read > 0;
4. the build records one hnsw.build.clustered_l<l> span for each clustered
   level, its rows those of the level draw.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import judge
from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.hnsw import build_large
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.models.hnsw.graph import assign_levels
from hnsw_tpu_torch.models.hnsw.shadow import HopShadow
from hnsw_tpu_torch.utils import tracing

N, NQ, DIM, K = 6000, 256, 100, 10
# layers of 6,000 rows: 6,000, 3,047, 1,549 past it, 750 below
LARGE_N = 1000
SIX = ("entry", "select", "expand", "score", "merge", "rerank")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def glove():
    """(rows, queries, the built index, the build's spans)."""
    x = generate_vectors(N + NQ, DIM, distribution="embedding",
                         num_clusters=32, seed=23)
    tracing.collect()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build_large, "LARGE_N", LARGE_N)
        idx = build_hnsw_index(x[:N], M=16, max_M0=32, ef_construction=200,
                               metric="cosine", device="cpu")
    return x[:N], x[N:], idx, tracing.collect().spans


def _pack_bytes(adj0, width):
    """(bf16, int8) pack bytes of HopShadow.prepare."""
    slots = adj0.shape[0] * adj0.shape[1]
    return slots * (2 * width + 4), slots * (width + 8)


@pytest.fixture
def int8_cap(glove, monkeypatch):
    """The pack cap between the int8 and the bf16 pack's bytes."""
    bf16, int8 = _pack_bytes(glove[2].graph.adj0, 128)
    monkeypatch.setitem(HopShadow.prepare.__kwdefaults__, "cap",
                        (bf16 + int8) // 2)


def _index(glove, **kw):
    """A fresh index over the built graph: its own shadow and pack."""
    built = glove[2]
    return HNSWIndex(built.corpus, built.graph, **kw)


def test_auto_takes_the_int8_pack(glove, int8_cap):
    idx = _index(glove)
    tracing.collect()
    _, key = idx._search_fn(K, "balanced", None, False)
    spans = [s for s in tracing.collect().spans if s.name == "hnsw.pack"]
    assert key[6:8] == ("int8", 128)
    assert idx._shadow.nbr_pack.dtype == torch.int8
    assert idx._shadow.nbr_scale is not None
    _, int8 = _pack_bytes(idx.graph.adj0, 128)
    assert [s.attrs for s in spans] == [{"precision": "int8", "bytes": int8}]


def test_int8_route_answers_pass_the_plain_reference(glove, int8_cap):
    rows, queries, _, _ = glove
    idx = _index(glove)
    d, r = idx.search_batch(queries, K, "balanced")
    assert idx._shadow.nbr_pack.dtype == torch.int8
    got = judge(rows, queries, np.arange(NQ), r.numpy().astype(np.int64),
                d.numpy(), k=K, metric="cosine", device="cpu")
    assert got["invalid_answers"] == 0
    assert got["max_dist_gap"] <= 4e-6
    assert got["recall_at_10"] >= 0.95


@pytest.mark.parametrize("route", ["int8", "bf16", "f32"])
def test_dequant_phase_reads_only_on_the_int8_route(route, glove,
                                                    monkeypatch, request):
    if route == "int8":
        request.getfixturevalue("int8_cap")
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    idx = _index(glove, precision="highest" if route == "f32" else "auto")
    q = glove[1][:64]
    d0, r0 = idx.search_batch(q, K, "balanced")
    tracing.enable_device(True)
    try:
        tracing.collect()
        d1, r1 = idx.search_batch(q, K, "balanced")
        got = tracing.collect()
    finally:
        tracing.enable_device(False)
    assert torch.equal(r0, r1) and torch.equal(d0, d1)
    pack = idx._shadow.nbr_pack
    assert (None if pack is None else pack.dtype) == {
        "int8": torch.int8, "bf16": torch.bfloat16, "f32": None}[route]
    assert got.runs == 1
    assert all(got.phase_ms[p] > 0 for p in SIX), got.phase_ms
    assert got.phase_ms["count"] > 0
    if route == "int8":
        assert got.phase_ms["dequant"] > 0
    else:
        assert got.phase_ms["dequant"] == 0


def test_each_clustered_level_records_its_span(glove):
    """One hnsw.build.clustered_l<l> span a level past LARGE_N, inside
    hnsw.build.layers, its rows the level draw's and its cells the
    clustered builder's, which records its hnsw.build.large inside it."""
    spans = glove[3]
    lv = assign_levels(N, 1.0 / math.log(2.0), 42,
                       max_cap=max(int(math.log2(N)), 1))
    sizes = [int((lv >= l).sum()) for l in range(int(lv.max()) + 1)]
    clustered = [l for l, n in enumerate(sizes) if n > LARGE_N]
    assert clustered == [0, 1, 2]
    (root,) = [s for s in spans if s.name == "hnsw.build"]
    (layers,) = [s for s in spans if s.name == "hnsw.build.layers"]
    got = {s.name: s for s in spans
           if s.name.startswith("hnsw.build.clustered_l")}
    assert sorted(got) == [f"hnsw.build.clustered_l{l}" for l in clustered]
    for l in clustered:
        span = got[f"hnsw.build.clustered_l{l}"]
        assert span.parent == layers.id and span.request == root.id
        assert span.attrs == {"rows": sizes[l],
                              "cells": build_large.cell_count(sizes[l])}
        (large,) = [s for s in spans if s.name == "hnsw.build.large"
                    and s.parent == span.id]
        assert large.attrs["rows"] == sizes[l]
        assert large.attrs["cells"] == span.attrs["cells"]
        assert span.start_ns <= large.start_ns <= large.end_ns <= \
            span.end_ns

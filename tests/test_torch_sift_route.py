"""The route of the sift-128-euclidean deployment (a million rows x 128,
euclidean) on the CPU, at a small size; no JAX.

A 6,000 x 128 euclidean index built through build_hnsw_index with LARGE_N
lowered so that layers 0-2 take the clustered builder (as a million rows do
with LARGE_N as shipped; layer 0 spans two cells of 4,096 rows, so its
NN-descent round runs) and build.F32_BUILD_MAX lowered below the rows, so
that build_precision "auto" gives the layers bf16 products, as a million
rows get. The rows are the embedding generator's scaled to norms in
[0.5, 2], so that their euclidean neighbours are not their cosine ones.
Searched through HNSWIndex.search_batch:

1. the loop keeps f32 ("highest") with no shadow and no pack;
2. the answers match an exact float64 euclidean kNN in plain torch at
   recall@10 >= 0.95, every row valid, and their distances the exact ones
   within f32 rounding (the gap of the squares over |q|^2 + |x|^2, at most
   4e-6, the cell's limit);
3. hnsw.build names the metric, and each clustered layer's
   hnsw.build.large the metric and the bf16 products;
4. with the card's fixed-length loop forced and a stand-in for the
   gather-score kernel (G1) that counts its launches, every body's score
   launched it: hop.score_kernel_bodies == hop.bodies_run, and the rows are
   those of the untraced search.
"""

import math

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.hnsw import build, build_large
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.models.hnsw.graph import assign_levels
from hnsw_tpu_torch.ops import gather
from hnsw_tpu_torch.utils import tracing

N, NQ, DIM, K = 6000, 256, 128, 10
# layers of 6,000 rows: 6,000, 3,047, 1,549 past it, 750 below
LARGE_N = 1000


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sift():
    """(rows, queries, the built index, the build's spans)."""
    x = generate_vectors(N + NQ, DIM, distribution="embedding",
                         num_clusters=32, seed=25)
    x *= np.random.default_rng(26).uniform(0.5, 2.0, (N + NQ, 1)).astype(
        np.float32)
    tracing.collect()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build_large, "LARGE_N", LARGE_N)
        mp.setattr(build, "F32_BUILD_MAX", N // 2)
        idx = build_hnsw_index(x[:N], M=16, max_M0=32, ef_construction=200,
                               metric="euclidean", device="cpu")
    return x[:N], x[N:], idx, tracing.collect().spans


def _exact(rows, queries, k):
    """(squared distances [Q, k], rows [Q, k]) of the exact euclidean kNN,
    float64."""
    x = torch.from_numpy(rows).double()
    q = torch.from_numpy(queries).double()
    d = ((q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :]
         - 2.0 * q @ x.T).clamp(min=0.0)
    return torch.topk(d, k, dim=1, largest=False)


def test_the_loop_stays_f32_with_no_pack(sift):
    idx = HNSWIndex(sift[2].corpus, sift[2].graph)
    route = idx._shadow.prepare(idx.corpus, idx.graph.adj0)
    assert (route.precision, route.pack, route.proj) == ("highest", None,
                                                         None)
    assert route.kwargs == {"precision": "highest"}
    assert idx._shadow.vectors_lp is None and idx._shadow.nbr_pack is None
    _, key = idx._search_fn(K, "balanced", None, False)
    assert key[2] == "highest" and key[6:8] == (None, DIM)


def test_answers_match_exact_float64_knn(sift):
    rows, queries, idx, _ = sift
    d, r = idx.search_batch(queries, K, "balanced")
    d, r = d.double(), r.long()
    assert ((r >= 0) & (r < N)).all()
    assert all(len(set(row.tolist())) == K for row in r)
    assert (torch.diff(d, dim=1) >= 0).all()
    _, top = _exact(rows, queries, K)
    got = (r[:, :, None] == top[:, None, :]).any(2).double().mean().item()
    assert got >= 0.95, got
    # the rows' exact squared distances, and the scale of their terms
    x = torch.from_numpy(rows).double()[r]                     # [Q, K, D]
    q = torch.from_numpy(queries).double()[:, None, :]
    want = ((q - x) ** 2).sum(-1)
    scale = (q * q).sum(-1) + (x * x).sum(-1)
    gap = ((d * d - want).abs() / scale).max().item()
    assert gap <= 4e-6, gap
    # the corpus's euclidean neighbours are not its cosine ones
    xs = torch.nn.functional.normalize(torch.from_numpy(rows).double())
    qs = torch.nn.functional.normalize(torch.from_numpy(queries).double())
    cos_top = torch.topk(qs @ xs.T, K, dim=1).indices
    assert (torch.sort(cos_top).values != torch.sort(top).values).any(1) \
        .double().mean() > 0.5


def test_clustered_layers_record_the_euclidean_bf16_route(sift):
    spans = sift[3]
    lv = assign_levels(N, 1.0 / math.log(2.0), 42,
                       max_cap=max(int(math.log2(N)), 1))
    sizes = [int((lv >= l).sum()) for l in range(int(lv.max()) + 1)]
    assert [l for l, n in enumerate(sizes) if n > LARGE_N] == [0, 1, 2]
    (root,) = [s for s in spans if s.name == "hnsw.build"]
    assert root.attrs == {"rows": N, "metric": "euclidean"}
    large = [s for s in spans if s.name == "hnsw.build.large"]
    assert [s.attrs["rows"] for s in large] == sizes[:3]
    for s in large:
        assert (s.attrs["metric"], s.attrs["precision"]) == ("euclidean",
                                                             "bf16")
    # layer 0 spans more than one cell, so its NN-descent round ran
    assert large[0].attrs["cells"] == build_large.cell_count(N) > 1
    (refine,) = [s for s in spans if s.name == "hnsw.build.large.refine"
                 and s.parent == large[0].id]
    assert refine.attrs == {"rounds": 1}


def test_g1_scores_every_body(sift, monkeypatch):
    """The card's fixed-length loop, forced on the CPU, with a stand-in for
    G1 (the plain version, counting a launch as the kernel's wrapper does):
    hop.score_kernel_bodies counts every body, and the rows and distances
    are those of the untraced search."""
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)

    def counting(*args, **kw):
        counting.launches += 1
        return gather.hop_gather_score_plain(*args, **kw)
    counting.launches = 0
    monkeypatch.setattr(gather, "hop_gather_score", counting)
    idx = HNSWIndex(sift[2].corpus, sift[2].graph)
    q = sift[1][:64]
    d0, r0 = idx.search_batch(q, K, "balanced")
    tracing.enable_device(True)
    try:
        tracing.collect()
        d1, r1 = idx.search_batch(q, K, "balanced")
        got = tracing.collect()
    finally:
        tracing.enable_device(False)
    assert torch.equal(r0, r1) and torch.equal(d0, d1)
    max_hops = 200 // 4 + 12
    c = got.counters
    assert c["hop.bodies_run"] == max_hops
    assert c["hop.score_kernel_bodies"] == c["hop.bodies_run"]
    assert c["hop.slots_valid"] > 0

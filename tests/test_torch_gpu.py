"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `gpu` and skips on a host without a CUDA card. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; on the card:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: kernel and plain version form the same exact bf16 x bf16
(bf16 x int8, s8 x s8) products and differ only in the order of the f32
sums; bucket rows may differ only where two keys tie within that error.
The int8 floors (int32 dots) agree bit for bit.
"""

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import (FlatIndex, HNSWIndex, IVFHNSWIndex,
                                   PartitionedHNSWIndex, build_hnsw_index,
                                   build_ivf_hnsw_index,
                                   build_partitioned_hnsw)
from hnsw_tpu_torch.models.flat import quantize_rows
from hnsw_tpu_torch.ops import hop, probes, scan
from hnsw_tpu_torch.types import Corpus

pytestmark = pytest.mark.gpu

KEY_TOL = 2e-5


@pytest.fixture
def cuda_device():
    """The CUDA card; skips where there is none. Decided when the test
    runs, never at import, so every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def recall(rows, exact_rows) -> float:
    hit = (rows[:, :, None] == exact_rows[:, None, :]).any(-1) & (rows >= 0)
    return float(hit.float().sum(-1).mean()) / exact_rows.shape[1]


def test_hop_kernels_match_plain_versions(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(0)
    for b, e, m0, d, n in ((5, 3, 8, 128, 64), (300, 4, 32, 768, 2000),
                           (1, 1, 7, 16, 3)):
        pack = torch.randn(n, m0, d, generator=g).to(torch.bfloat16)
        codes = torch.randint(-127, 128, (n, m0, d), generator=g,
                              dtype=torch.int8)
        q = torch.randn(b, d, generator=g)
        sel = torch.randint(-1, n, (b, e), generator=g, dtype=torch.int32)
        args = [t.to(cuda_device) for t in (pack, q, sel)]
        before = hop.hop_score.launches
        kd, kc = hop.hop_score(*args)
        assert hop.hop_score.launches == before + 1
        pd, pc = hop.hop_score_plain(*args)
        np.testing.assert_allclose(kd.cpu(), pd.cpu(), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(kc.cpu(), pc.cpu(), rtol=1e-5)
        args[0] = codes.to(cuda_device)
        np.testing.assert_allclose(hop.hop_score_int8(*args).cpu(),
                                   hop.hop_score_int8_plain(*args).cpu(),
                                   rtol=1e-5, atol=5e-2)


def test_hop_kernel_refuses_what_it_cannot_take(cuda_device):
    pack = torch.zeros((4, 8, 24), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((2, 24), device=cuda_device)
    sel = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):          # D not a multiple of 16
        hop.hop_score(pack, q, sel)
    with pytest.raises(ValueError):          # int64 rows
        hop.hop_score(pack[:, :, :16].contiguous(), q[:, :16].contiguous(),
                      sel.long())


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_bucket_banks_match_plain_versions(metric, cuda_device):
    g = torch.Generator(device="cpu").manual_seed(1)
    for b, n_pad, d, n in ((70, 1024, 256, 1000), (300, 4096, 768, 4000),
                           (8, 128, 128, 5)):
        v = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g),
                                          dim=1)
        q = v[torch.randint(0, n, (b,), generator=g)]
        vsq = (v * v).sum(1)
        vb, qb = v.to(torch.bfloat16), q.to(torch.bfloat16)
        args = [t.to(cuda_device) for t in (vb, scan.bf16_vkey(vsq, metric),
                                            qb)]
        kd, kr = scan.bucket_bank(*args, n, metric=metric)
        pd, pr = scan.bucket_bank_plain(*args, n, metric=metric, nt=128)
        live = (pd < 1e29).cpu()
        np.testing.assert_allclose(kd.cpu()[live], pd.cpu()[live],
                                   atol=KEY_TOL)
        assert ((kr == pr).cpu()[live]).float().mean() > 0.999
        assert (kd.cpu()[~live] >= 1e29).all()

        v8, vs = quantize_rows(v)
        q8, qs = quantize_rows(q)
        args = [t.to(cuda_device) for t in (v8, scan.int8_vkey(vs, vsq, metric),
                                            vs, q8, qs)]
        kd, kr = scan.int8_bucket_bank(*args, n, metric=metric)
        pd, pr = scan.int8_bucket_bank_plain(*args, n, metric=metric, nt=128)
        live = (pd < 1e29).cpu()
        np.testing.assert_allclose(kd.cpu()[live], pd.cpu()[live],
                                   rtol=1e-6, atol=1e-5)
        assert ((kr == pr).cpu()[live]).float().mean() > 0.999


def test_main_path_on_the_card_matches_the_plain_path(cuda_device):
    """The whole slice at a small size: the same index on the card (CUDA
    kernels) and on the CPU (their plain versions)."""
    data = generate_vectors(3000, 128, distribution="embedding",
                            num_clusters=16, seed=3)
    q = data[:256]
    gpu = build_hnsw_index(data, device=cuda_device)
    cpu = HNSWIndex.from_state(
        Corpus.from_array(data, device="cpu"), gpu.to_state())
    for pp in ("bf16", "int8"):
        gpu.pack_precision = cpu.pack_precision = pp
        before = (hop.hop_score.launches, hop.hop_score_int8.launches)
        gd, gr = gpu.search_batch(q, 10, "balanced")
        assert (hop.hop_score.launches, hop.hop_score_int8.launches) != before
        cd, cr = cpu.search_batch(q, 10, "balanced")
        same = (gr.cpu() == cr).all(dim=1).float().mean()
        assert same >= 0.99
    exact = FlatIndex(gpu.corpus)
    _, er = exact.search_batch(q, 10)
    for precision, fetch, bar in (("bf16", None, 0.98), ("int8", None, 0.98),
                                  ("int8", 0, 0.95)):
        idx = FlatIndex(gpu.corpus, precision=precision, int8_fetch=fetch)
        _, r = idx.search_batch(q, 10)
        assert recall(r, er) >= bar


def _int8_inputs(v, q, vsq):
    v8, vs = quantize_rows(v)
    q8, qs = quantize_rows(q)
    qmeta = torch.stack([qs, (q * q).sum(1)], dim=1)
    return v8, vs, vsq, q8, qmeta


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_sweep_kernels_match_plain_versions(metric, cuda_device):
    g = torch.Generator(device="cpu").manual_seed(2)
    for b, n_pad, d, n, k in ((70, 1024, 256, 1000, 10),
                              (300, 4096, 768, 4000, 32),
                              (8, 128, 128, 5, 10)):
        v = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g),
                                          dim=1)
        q = v[torch.randint(0, n, (b,), generator=g)] + 0.01
        vsq = (v * v).sum(1)
        args = [t.to(cuda_device) for t in (v.to(torch.bfloat16), vsq,
                                            q.to(torch.bfloat16))]
        before = scan.exact_topk_sweep.launches
        kd, kr = scan.exact_topk_sweep(*args, n, k=k, metric=metric, bt=b,
                                       nt=128)
        assert scan.exact_topk_sweep.launches == before + 1
        pd, pr = scan.exact_topk_sweep_plain(*args, n, k=k, metric=metric,
                                             nt=128)
        p = 2 if metric == "euclidean" else 1
        np.testing.assert_allclose((kd.cpu() ** p)[pd.cpu() < 1e29],
                                   (pd.cpu() ** p)[pd.cpu() < 1e29],
                                   atol=KEY_TOL)
        assert (kr == pr).float().mean() >= 0.99
        assert ((kr.cpu() == -1) == (pr.cpu() == -1)).all()

        args = [t.to(cuda_device) for t in _int8_inputs(v, q, vsq)]
        kd, kr = scan.int8_sweep_topk(*args, n, k=k, metric=metric, bt=b,
                                      nt=128)
        pd, pr = scan.int8_sweep_topk_plain(*args, n, k=k, metric=metric,
                                            nt=128)
        np.testing.assert_allclose(kd.cpu(), pd.cpu(), rtol=1e-6, atol=1e-6)
        assert (kr == pr).float().mean() >= 0.99


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_packed_kernel_matches_plain_version(metric, cuda_device):
    g = torch.Generator(device="cpu").manual_seed(3)
    for b, n_pad, d, n, nt in ((70, 1024, 256, 1000, 256),
                               (300, 8192, 768, 8000, 2048),
                               (8, 256, 128, 5, 256)):
        v = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g),
                                          dim=1)
        q = v[torch.randint(0, n, (b,), generator=g)]
        v8, vs, vsq, q8, qmeta = [t.to(cuda_device) for t in
                                  _int8_inputs(v, q, (v * v).sum(1))]
        nvkey = -scan.int8_vkey(vs, vsq, metric)
        before = scan.int8_packed_topk.launches
        kd, kr = scan.int8_packed_bank(v8, nvkey, q8, n, nt=nt)
        assert scan.int8_packed_topk.launches == before + 1
        pd, pr = scan.int8_packed_bank_plain(v8, nvkey, q8, n, nt=nt)
        # the best two keys of a bucket do not depend on the fold order
        torch.testing.assert_close(kd, pd, rtol=0, atol=0)
        live = pd < 1e29
        assert (kr == pr)[live].float().mean() >= 0.99
        dk, rk = scan.int8_packed_topk(v8, vs, vsq, q8, qmeta, n, k=10,
                                       metric=metric, bt=b, nt=nt)
        assert ((rk >= 0) & (rk < n)).all() or n < 10


def test_flat_scan_kernels_on_the_card(cuda_device):
    """Every scan_kernel route of FlatIndex launches its kernel on the card
    and answers at the reference tests' recall bars; an unnormalized DOT
    corpus takes the bucket kernel instead of "packed"."""
    data = generate_vectors(3000, 128, distribution="embedding",
                            num_clusters=16, seed=4)
    q = data[:256]
    corpus = Corpus.from_array(data, device=cuda_device)
    _, er = FlatIndex(corpus).search_batch(q, 10)
    for precision, kernel, fetch, counter, bar in (
            ("bf16", "sweep", None, scan.exact_topk_sweep, 0.98),
            ("int8", "sweep", None, scan.int8_sweep_topk, 0.98),
            ("int8", "sweep", 0, scan.int8_sweep_topk, 0.95),
            ("int8", "packed", None, scan.int8_packed_topk, 0.98),
            ("int8", "packed", 0, scan.int8_packed_topk, 0.95)):
        idx = FlatIndex(corpus, precision=precision, scan_kernel=kernel,
                        int8_fetch=fetch)
        before = counter.launches
        _, r = idx.search_batch(q, 10)
        assert counter.launches == before + 1
        assert recall(r, er) >= bar
    big = Corpus.from_array(100.0 * data, metric="dot", device=cuda_device)
    before = (scan.int8_packed_topk.launches, scan.int8_bucket_topk.launches)
    FlatIndex(big, precision="int8", scan_kernel="packed").search_batch(q, 10)
    assert (scan.int8_packed_topk.launches,
            scan.int8_bucket_topk.launches) == (before[0], before[1] + 1)


@pytest.mark.parametrize("b,n,d", [(1024, 4096, 768), (37, 1000, 256)])
def test_bf16_floors_match_plain_versions(b, n, d, cuda_device):
    """The second shape has a B and an N that are not tile multiples (the
    wrapper pads N to 128 rows of zeros, which add nothing). The sums are
    exact bf16 products taken in another order: 1e-3 * max |out|."""
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(b, d, generator=g).to(torch.bfloat16).to(cuda_device)
    v = torch.randn(n, d, generator=g).to(torch.bfloat16).to(cuda_device)
    want = probes.mm_only_plain(q, v)
    for fn, arg in ((probes.mm_only, v), (probes.mm_only_nt, v),
                    (probes.mm_only_kmajor, v.T.contiguous())):
        before = fn.launches
        got = fn(q, arg)
        assert fn.launches == before + 1
        assert float((got - want).abs().max()) <= \
            1e-3 * float(want.abs().max())


@pytest.mark.parametrize("b,n,d,nt", [(4096, 32768, 768, 2048),
                                      (37, 5000, 256, 2048)])
def test_int8_floors_match_plain_versions(b, n, d, nt, cuda_device):
    """int32 dots are exact: bit for bit. The second shape has a B and an N
    that are not tile multiples (the last whole nt tile is kept)."""
    g = torch.Generator(device="cpu").manual_seed(6)
    q8 = torch.randint(-127, 128, (b, d), generator=g,
                       dtype=torch.int8).to(cuda_device)
    v8 = torch.randint(-127, 128, (n, d), generator=g,
                       dtype=torch.int8).to(cuda_device)
    for fn, plain in ((probes.matmul_only, probes.matmul_only_plain),
                      (probes.matmul_min, probes.matmul_min_plain)):
        before = fn.launches
        got = fn(q8, v8, nt=nt)
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(q8, v8, nt=nt), rtol=0, atol=0)


def test_families_on_the_card_match_the_plain_path(cuda_device):
    """Partitioned HNSW and IVF-HNSW built on the card search through the
    hop_score kernel; the same index on the CPU (plain versions) returns
    the same rows for >= 99% of queries (bf16 sums in another order reorder
    only near-ties)."""
    data = generate_vectors(3000, 128, distribution="embedding",
                            num_clusters=16, seed=7)
    q = data[:256]
    for build, cls, kw in (
            (build_partitioned_hnsw, PartitionedHNSWIndex,
             dict(num_partitions=4)),
            (build_ivf_hnsw_index, IVFHNSWIndex, dict(num_partitions=8))):
        gpu = build(data, device=cuda_device, **kw)
        cpu = cls.from_state(Corpus.from_array(data, device="cpu"),
                             gpu.to_state())
        before = hop.hop_score.launches
        _, gr = gpu.search_batch(q, 10, "balanced")
        assert hop.hop_score.launches > before
        _, cr = cpu.search_batch(q, 10, "balanced")
        assert (gr.cpu() == cr).all(dim=1).float().mean() >= 0.99
        assert bool((gr >= 0).all())

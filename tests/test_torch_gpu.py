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

from hnsw_tpu_torch.entry import entry
from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import (FlatIndex, HNSWIndex, IVFHNSWIndex,
                                   PartitionedHNSWIndex, build_hnsw_index,
                                   build_ivf_hnsw_index,
                                   build_partitioned_hnsw)
from hnsw_tpu_torch.models.flat import quantize_rows
from hnsw_tpu_torch.ops import (descent, expand, gather, hop, merge, probes,
                                scan)
from hnsw_tpu_torch.types import Corpus
from hnsw_tpu_torch.utils.graphs import CapturedCall, kernel_wrappers
from test_torch_merge import inputs as merge_cases

pytestmark = pytest.mark.gpu

KEY_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


# (B, E, M0, D, N_pad): B = 1; B < 132 SMs; B * E groups far above the
# persistent blocks, so each walks many and the 16-stage ring wraps; E * M0
# not a multiple of the rows a warp-step takes (M0 = 7, 9, 11); D = 16
# (16 rows a warp-step), 128 (two), 768 (three chunks a lane), 1,536 (the
# query read per chunk), 2,064 (two rows of 4,128 bytes a 12,288-byte
# stage, 129 chunks: the last lane group partly idle) and 6,160 and 16,384
# (a row of 12,320 / 32,768 bytes, longer than a stage: in two and three
# pieces); M0 = 96 at D = 128 (a block of 24 KiB in two stages of 48 rows)
HOP_SHAPES = [(1, 4, 32, 768, 64), (5, 3, 8, 128, 64), (300, 4, 32, 768, 2000),
              (1, 1, 7, 16, 3), (37, 3, 7, 768, 50), (5, 2, 9, 128, 50),
              (3, 5, 11, 1536, 50), (2, 2, 5, 2064, 50), (4, 1, 3, 16, 50),
              (1000, 8, 32, 128, 4000), (130, 4, 96, 128, 300),
              (3, 2, 3, 6160, 20), (2, 2, 2, 16384, 10)]


@pytest.mark.parametrize("b,e,m0,d,n", HOP_SHAPES)
def test_hop_kernels_match_plain_versions(b, e, m0, d, n, cuda_device):
    """hop_score at each shape within 1e-4 of the largest plain dot and
    squared norm (f32 sums of exact products in another order), and up to
    D = 768 also element by element as before (dots rtol 1e-5, atol 1e-3;
    norms rtol 1e-5), with rows -1 (row 0) and >= N_pad (the last row), one
    launch per call, and two calls giving the same bits; hop_score_int8 on
    the same rows (up to D = 768 also rtol 1e-5, atol 5e-2)."""
    g = torch.Generator(device="cpu").manual_seed(b * 7919 + d)
    pack = torch.randn(n, m0, d, generator=g).to(torch.bfloat16)
    q = torch.randn(b, d, generator=g)
    sel = torch.randint(-1, n, (b, e), generator=g, dtype=torch.int32)
    sel[0, 0] = -1
    sel[-1, -1] = n + 7
    args = [t.to(cuda_device) for t in (pack, q, sel)]
    before = hop.hop_score.launches
    kd, kc = hop.hop_score(*args)
    assert hop.hop_score.launches == before + 1
    assert kd.shape == kc.shape == (b, e * m0)
    clamped = torch.clamp(args[2], max=n - 1)
    pd, pc = hop.hop_score_plain(args[0], args[1], clamped)
    assert float((kd - pd).abs().max()) <= 1e-4 * float(pd.abs().max())
    assert float((kc - pc).abs().max()) <= 1e-4 * float(pc.abs().max())
    if d <= 768:
        np.testing.assert_allclose(kd.cpu(), pd.cpu(), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(kc.cpu(), pc.cpu(), rtol=1e-5)
    kd2, kc2 = hop.hop_score(*args)
    assert torch.equal(kd, kd2) and torch.equal(kc, kc2)
    if d <= 2064:
        codes = torch.randint(-127, 128, (n, m0, d), generator=g,
                              dtype=torch.int8).to(cuda_device)
        ki = hop.hop_score_int8(codes, args[1], args[2])
        pi = hop.hop_score_int8_plain(codes, args[1], clamped)
        assert float((ki - pi).abs().max()) <= 1e-4 * float(pi.abs().max())
        if d <= 768:
            np.testing.assert_allclose(ki.cpu(), pi.cpu(), rtol=1e-5,
                                       atol=5e-2)


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
    # (70, 1024, 1536, 1000): rows of 3,072 bytes, whose query block the
    # bf16 kernel streams through its ring instead of keeping it resident
    for b, n_pad, d, n in ((70, 1024, 256, 1000), (300, 4096, 768, 4000),
                           (8, 128, 128, 5), (70, 1024, 1536, 1000)):
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
    """Besides the first three shapes: B = 1 over 16 corpus splits (32
    partial lists) with n not a multiple of 128 and k = 1; rows of 3,072
    bytes, whose bf16 query block the kernel streams through its ring, at
    k = 32; then exact ties (below)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    for b, n_pad, d, n, k in ((70, 1024, 256, 1000, 10),
                              (300, 4096, 768, 4000, 32),
                              (8, 128, 128, 5, 10),
                              (1, 20480, 256, 20000, 1),
                              (70, 1024, 1536, 1000, 32)):
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

    # Exact ties: five distinct vectors repeated in a fixed pattern, so each
    # query's list is made of copies of one vector, spread over both
    # consumers' 64-column halves of every tile and over 16 corpus splits;
    # the tie rule (the lower row) alone picks the rows, which must be the
    # plain version's. n is not a multiple of 128.
    b, n_pad, d, n = 70, 4096, 256, 4000
    base = torch.nn.functional.normalize(torch.randn(5, d, generator=g), dim=1)
    pattern = (torch.arange(n_pad) * 7 + torch.arange(n_pad) // 300) % 5
    v = base[pattern]
    q = (base[torch.randint(0, 5, (b,), generator=g)]
         + 0.02 * torch.randn(b, d, generator=g))
    vsq = (v * v).sum(1)
    assert scan.sweep_plan(-(-b // 64), n_pad // 128,
                           scan._sms(cuda_device)) == (16, 32)
    for k in (1, 10, 32):
        args = [t.to(cuda_device) for t in (v.to(torch.bfloat16), vsq,
                                            q.to(torch.bfloat16))]
        kd, kr = scan.exact_topk_sweep(*args, n, k=k, metric=metric, bt=b,
                                       nt=128)
        pd, pr = scan.exact_topk_sweep_plain(*args, n, k=k, metric=metric,
                                             nt=128)
        assert bool(torch.equal(kr, pr))
        p = 2 if metric == "euclidean" else 1
        np.testing.assert_allclose(kd.cpu() ** p, pd.cpu() ** p, atol=KEY_TOL)
        args = [t.to(cuda_device) for t in _int8_inputs(v, q, vsq)]
        kd, kr = scan.int8_sweep_topk(*args, n, k=k, metric=metric, bt=b,
                                      nt=128)
        pd, pr = scan.int8_sweep_topk_plain(*args, n, k=k, metric=metric,
                                            nt=128)
        assert bool(torch.equal(kr, pr))
        np.testing.assert_allclose(kd.cpu(), pd.cpu(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_packed_kernel_matches_plain_version(metric, cuda_device):
    """Bank keys bit for bit at nt = 128 (group 1, gbits 1), 256, 2048 and
    4096; B = 1 and B not a multiple of 64; n a multiple of neither 128 nor
    nt; more than 2 corpus splits (B = 1: one split per nt-row tile, up to
    16). Then duplicated corpus rows in one bucket, within one nt-row tile
    (the group bits order them) and across nt-row tiles (the _merge_pair2
    tie rule), in one split, where rows must be the plain version's."""
    g = torch.Generator(device="cpu").manual_seed(3)
    sms = scan._sms(cuda_device)
    for b, n_pad, d, n, nt in ((70, 1024, 256, 1000, 256),
                               (300, 8192, 768, 8000, 2048),
                               (8, 256, 128, 5, 256),
                               (1, 2048, 256, 1900, 128),
                               (1, 16384, 768, 15999, 2048),
                               (100, 8192, 256, 8100, 4096)):
        v = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g),
                                          dim=1)
        q = v[torch.randint(0, n, (b,), generator=g)]
        v8, vs, vsq, q8, qmeta = [t.to(cuda_device) for t in
                                  _int8_inputs(v, q, (v * v).sum(1))]
        nvkey = -scan.int8_vkey(vs, vsq, metric)
        if b == 1:
            assert scan.split_plan(1, n_pad // nt, sms) > 2
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

    # Duplicates: rows r and r + 256 are one vector, so at nt = 512 every
    # nt-row tile holds two copies of each of a bucket's two vectors. 64
    # queries per SM fill the card with query blocks, so one split walks
    # every tile and the rows are the plain version's exactly.
    b, n_pad, d, n, nt = 64 * sms, 2048, 128, 1950, 512
    assert scan.split_plan(-(-b // 64), n_pad // nt, sms) == 1
    base = torch.nn.functional.normalize(torch.randn(256, d, generator=g),
                                         dim=1)
    v = base[torch.arange(n_pad) % 256]
    q = base[torch.randint(0, 256, (b,), generator=g)] + \
        0.1 * torch.randn(b, d, generator=g)
    v8, vs, vsq, q8, _ = [t.to(cuda_device) for t in
                          _int8_inputs(v, q, (v * v).sum(1))]
    nvkey = -scan.int8_vkey(vs, vsq, metric)
    kd, kr = scan.int8_packed_bank(v8, nvkey, q8, n, nt=nt)
    pd, pr = scan.int8_packed_bank_plain(v8, nvkey, q8, n, nt=nt)
    torch.testing.assert_close(kd, pd, rtol=0, atol=0)
    assert bool(torch.equal(kr, pr))
    # every kept pair is a tie: both halves of the bank hold equal keys
    assert bool(torch.equal(kd[:, :128], kd[:, 128:]))


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


@pytest.mark.parametrize("b,n,d,asymmetric", [
    (1024, 4096, 768, False), (37, 1000, 256, False),
    (100, 1088, 320, True), (70, 1000, 1536, False), (64, 8000, 256, False),
    (8448, 1024, 128, False)])
def test_bf16_floors_match_plain_versions(b, n, d, asymmetric, cuda_device):
    """The second shape has a B and an N that are not tile multiples (the
    wrapper pads N to 128 rows of zeros, which add nothing). The third is
    asymmetric (N != D, B not a multiple of 64, rows of unequal scale), and
    reading each 64 x 64 block of vT transposed would give other sums: a
    wrong MN-major operand of mm_only_kmajor fails it. The fourth has rows of
    3,072 bytes, whose query block the kernels stream through their ring; the
    fifth runs one query block over 16 corpus splits of unequal size; the
    last fills the card's 132 SMs with query blocks alone, so its one split
    writes the output directly. The sums are exact bf16 products taken in
    another order: 1e-3 * max |out|."""
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(b, d, generator=g).to(torch.bfloat16).to(cuda_device)
    v = torch.randn(n, d, generator=g)
    if asymmetric:
        v = v * (1 + torch.arange(n) % 7)[:, None] + torch.arange(d) / d
    v = v.to(torch.bfloat16).to(cuda_device)
    vT = v.T.contiguous()
    want = probes.mm_only_plain(q, v)
    tol = 1e-3 * float(want.abs().max())
    if asymmetric:
        blocks = vT.reshape(d // 64, 64, n // 64, 64).transpose(1, 3)
        wrong = probes.mm_only_kmajor_plain(q, blocks.reshape(d, n))
        assert float((wrong - want).abs().max()) > 100 * tol
    splits = scan._splits(-(-b // 64), -(-n // 128), cuda_device)
    assert (splits == 1) == (b == 8448)
    for fn, arg in ((probes.mm_only, v), (probes.mm_only_nt, v),
                    (probes.mm_only_kmajor, vT)):
        before = fn.launches
        got = fn(q, arg)
        assert fn.launches == before + 1
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("b,n,d,nt", [(4096, 32768, 768, 2048),
                                      (37, 5000, 256, 2048),
                                      (100, 3000, 3072, 1024),
                                      (1, 9000, 256, 1024),
                                      (65, 20480, 384, 1024)])
def test_int8_floors_match_plain_versions(b, n, d, nt, cuda_device):
    """int32 dots are exact: bit for bit. The second shape has a B and an N
    that are not tile multiples (the last whole nt tile is kept); the third
    has rows of 3,072 bytes, whose query block the kernels stream through
    their ring instead of keeping it resident; the last two are B = 1 and 20
    nt tiles over 16 splits. In each the kept nt tile lies in the last of
    several corpus splits."""
    g = torch.Generator(device="cpu").manual_seed(6)
    q8 = torch.randint(-127, 128, (b, d), generator=g,
                       dtype=torch.int8).to(cuda_device)
    v8 = torch.randint(-127, 128, (n, d), generator=g,
                       dtype=torch.int8).to(cuda_device)
    assert scan._splits(-(-b // 64), n // nt, cuda_device) > 1
    for fn, plain in ((probes.matmul_only, probes.matmul_only_plain),
                      (probes.matmul_min, probes.matmul_min_plain)):
        before = fn.launches
        got = fn(q8, v8, nt=nt)
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(q8, v8, nt=nt), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_bucket_bank_breaks_exact_ties_like_the_plain_version(metric, kind,
                                                              cuda_device):
    """A corpus of five distinct vectors repeated in a fixed pattern: every
    kept key ties with others, in one tile (across buckets), in two tiles of
    one split and in two splits, so the tie rule alone picks every kept row.
    Identical rows give bit-identical keys on both sides, so the rows must
    equal the plain version's (nt=128) everywhere; n is not a multiple of
    128. The int8 bank's keys are the plain version's bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(9)
    b, n_pad, d, n = 70, 4096, 256, 4000
    base = torch.nn.functional.normalize(torch.randn(5, d, generator=g), dim=1)
    pattern = (torch.arange(n_pad) * 7 + torch.arange(n_pad) // 300) % 5
    v = base[pattern]
    q = (base[torch.randint(0, 5, (b,), generator=g)]
         + 0.02 * torch.randn(b, d, generator=g))
    vsq = (v * v).sum(1)
    assert scan._splits(-(-b // 64), n_pad // 128, cuda_device) > 1
    if kind == "bf16":
        args = [t.to(cuda_device) for t in
                (v.to(torch.bfloat16), scan.bf16_vkey(vsq, metric),
                 q.to(torch.bfloat16))]
        kd, kr = scan.bucket_bank(*args, n, metric=metric)
        pd, pr = scan.bucket_bank_plain(*args, n, metric=metric, nt=128)
    else:
        v8, vs = quantize_rows(v)
        q8, qs = quantize_rows(q)
        args = [t.to(cuda_device) for t in
                (v8, scan.int8_vkey(vs, vsq, metric), vs, q8, qs)]
        kd, kr = scan.int8_bucket_bank(*args, n, metric=metric)
        pd, pr = scan.int8_bucket_bank_plain(*args, n, metric=metric, nt=128)
        assert bool(torch.equal(kd, pd))
    live = pd < 1e29
    assert bool(live.all())
    assert bool(torch.equal(kr[live], pr[live]))
    np.testing.assert_allclose(kd[live].cpu(), pd[live].cpu(), atol=KEY_TOL)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("b,n_pad,d,n", [(1, 20480, 256, 20000),
                                         (8448, 1024, 128, 1000),
                                         (70, 4096, 3072, 4000)])
def test_int8_bucket_bank_is_the_plain_version_bit_for_bit(b, n_pad, d, n,
                                                           metric,
                                                           cuda_device):
    """The int8 bank forms exact s32 dots and the plain version's f32 key
    operations, and merges its splits in order with the plain version's
    tie rule, so keys and rows equal the plain version's (nt=128)
    everywhere. The shapes: B = 1 over 16 corpus splits, n not a multiple
    of 128; one split (132 query blocks fill the card's SMs); rows of 3,072
    bytes, whose query block the kernel streams through its ring."""
    g = torch.Generator(device="cpu").manual_seed(10)
    v = torch.nn.functional.normalize(torch.randn(n_pad, d, generator=g),
                                      dim=1)
    q = v[torch.randint(0, n, (b,), generator=g)] + 0.01
    if metric != "cosine":
        v = v * (1 + torch.arange(n_pad) % 3)[:, None]
    vsq = (v * v).sum(1)
    v8, vs = quantize_rows(v)
    q8, qs = quantize_rows(q)
    args = [t.to(cuda_device) for t in
            (v8, scan.int8_vkey(vs, vsq, metric), vs, q8, qs)]
    splits = scan._splits(-(-b // 64), n_pad // 128, cuda_device)
    assert (splits == 1) == (b == 8448) and (b > 1 or splits == 16)
    before = scan.int8_bucket_topk.launches
    kd, kr = scan.int8_bucket_bank(*args, n, metric=metric)
    assert scan.int8_bucket_topk.launches == before + 1
    pd, pr = scan.int8_bucket_bank_plain(*args, n, metric=metric, nt=128)
    assert bool(torch.equal(kd, pd))
    assert bool(torch.equal(kr, pr))


@pytest.mark.parametrize("b,e,m0,d", [(1, 4, 32, 768), (37, 3, 7, 768),
                                      (5, 2, 9, 128), (3, 5, 11, 1536),
                                      (2, 2, 5, 2064), (4, 1, 3, 16)])
def test_hop_score_int8_shapes(b, e, m0, d, cuda_device):
    """The int8 hop kernel at B = 1, at E * M0 that is not a multiple of the
    rows a warp scores at once, at D = 16 (one lane a row, 32 rows a
    warp-step), 128 (eight lanes a row, four rows a step), 768 (every lane
    on one row, two 16-byte chunks a lane), 1,536 (three chunks a lane) and
    2,064 (two passes of three chunks a lane, the second partly idle), with
    selected rows -1 (row 0) and >= N_pad (clamped to the last row): within
    1e-4 of the largest plain dot (f32 sums of exact products in another
    order)."""
    g = torch.Generator(device="cpu").manual_seed(11)
    n_pad = 50
    codes = torch.randint(-128, 128, (n_pad, m0, d), generator=g,
                          dtype=torch.int8).to(cuda_device)
    q = (10.0 ** torch.randint(-3, 4, (b, d), generator=g)
         * torch.randn(b, d, generator=g)).to(cuda_device)
    sel = torch.randint(0, n_pad, (b, e), generator=g, dtype=torch.int32)
    sel[0, 0] = -1
    sel[-1, -1] = n_pad + 7
    sel = sel.to(cuda_device)
    before = hop.hop_score_int8.launches
    got = hop.hop_score_int8(codes, q, sel)
    assert hop.hop_score_int8.launches == before + 1
    want = hop.hop_score_int8_plain(codes, q, torch.clamp(sel, max=n_pad - 1))
    assert got.shape == (b, e * m0)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_hop_score_int8_at_glove_hop(cuda_device):
    """The int8 hop kernel at glove-100-angular's hop (B 1,024, E 4, M0 32,
    D 128: the pack's zero tail past 100 dims, and the query's), with
    selected rows -1 (row 0) and >= N_pad (the last row): two calls give
    the same bits, the dots lie within 1e-4 of the largest plain dot and
    element by element within rtol 1e-5, atol 5e-2, and each call takes
    the narrow plan (narrow_launches steps once); a call at D = 768 does
    not."""
    g = torch.Generator(device="cpu").manual_seed(100)
    n_pad, b, e, m0 = 50_000, 1024, 4, 32
    codes = torch.randint(-127, 128, (n_pad, m0, 128), generator=g,
                          dtype=torch.int8)
    codes[:, :, 100:] = 0
    q = torch.randn(b, 128, generator=g)
    q[:, 100:] = 0
    sel = torch.randint(0, n_pad, (b, e), generator=g, dtype=torch.int32)
    sel[0, 0] = -1
    sel[5, 2] = -1
    sel[-1, -1] = n_pad + 7
    codes, q, sel = (t.to(cuda_device) for t in (codes, q, sel))
    before = (hop.hop_score_int8.launches, hop.hop_score_int8.narrow_launches)
    got = hop.hop_score_int8(codes, q, sel)
    assert (hop.hop_score_int8.launches,
            hop.hop_score_int8.narrow_launches) == (before[0] + 1,
                                                    before[1] + 1)
    again = hop.hop_score_int8(codes, q, sel)
    assert hop.hop_score_int8.narrow_launches == before[1] + 2
    assert torch.equal(got, again)
    want = hop.hop_score_int8_plain(codes, q, torch.clamp(sel, max=n_pad - 1))
    assert got.shape == (b, e * m0)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=5e-2)
    wide = torch.zeros((4, m0, 768), dtype=torch.int8, device=cuda_device)
    hop.hop_score_int8(wide, torch.zeros((2, 768), device=cuda_device),
                       torch.zeros((2, 1), dtype=torch.int32,
                                   device=cuda_device))
    assert hop.hop_score_int8.narrow_launches == before[1] + 2


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
        before = (hop.hop_score.launches, expand.hop_expand.launches)
        _, gr = gpu.search_batch(q, 10, "balanced")
        assert hop.hop_score.launches > before[0]
        assert expand.hop_expand.launches > before[1]
        _, cr = cpu.search_batch(q, 10, "balanced")
        assert (gr.cpu() == cr).all(dim=1).float().mean() >= 0.99
        assert bool((gr >= 0).all())


def _expand_inputs(b, e, m0, ef, n, device, kind="mixed", seed=0):
    """adj0 [n, m0] over the n rows (a tenth of the slots -1, so rows repeat
    ids and share them at small n), sel_ids [b, e] with a row selected twice
    in every third query and 15% -1, and a beam of ef that holds some of the
    query's candidates and other rows, then -1 slots. kind "unselected":
    every sel_id -1; "all_in_beam": each beam holds all its candidates."""
    g = torch.Generator().manual_seed(seed)
    adj0 = torch.randint(0, n, (n, m0), generator=g, dtype=torch.int32)
    adj0[torch.rand((n, m0), generator=g) < 0.1] = -1
    sel = torch.randint(0, n, (b, e), generator=g, dtype=torch.int32)
    if e > 1:
        sel[::3, 1] = sel[::3, 0]
    sel[torch.rand((b, e), generator=g) < 0.15] = -1
    if kind == "unselected":
        sel[:] = -1
    nb = torch.where(sel[:, :, None] >= 0, adj0[sel.clamp(min=0).long()],
                     -1).reshape(b, -1)
    pool = torch.cat([nb, torch.randint(0, n, (b, ef), generator=g,
                                        dtype=torch.int32)], dim=1)
    pick = torch.rand(pool.shape, generator=g).argsort(dim=1)[:, :ef]
    beam = torch.gather(pool, 1, pick)
    filled = torch.randint(0, ef + 1, (b, 1), generator=g)
    beam = torch.where(torch.arange(ef)[None, :] < filled, beam, -1)
    if kind == "all_in_beam":
        c = nb.shape[1]
        beam[:, :c] = nb
    return tuple(t.contiguous().to(device) for t in (adj0, sel, beam))


# (B, E, M0, ef, N, kind): the three cells' bodies (B = 1,024 and 100, E 4,
# M0 32, ef 200 over the Bible corpus's rows); B = 1; C = 21 with ef not a
# multiple of four; C = 512; a beam of 20,000 (80 KB of shared memory, past
# the 48 KB default); C = 1,500 (warps step over the slots); no row
# selected; every candidate already in the beam
EXPAND_SHAPES = [(1024, 4, 32, 200, 31173, "mixed"),
                 (100, 4, 32, 200, 31173, "mixed"),
                 (1024, 4, 32, 200, 300, "mixed"),
                 (1, 4, 32, 200, 100, "mixed"), (37, 3, 7, 50, 40, "mixed"),
                 (64, 8, 64, 300, 200, "mixed"),
                 (8, 4, 32, 20000, 5000, "mixed"),
                 (5, 5, 300, 13, 900, "mixed"),
                 (256, 4, 32, 200, 300, "unselected"),
                 (256, 4, 32, 200, 300, "all_in_beam")]


@pytest.mark.parametrize("b,e,m0,ef,n,kind", EXPAND_SHAPES)
def test_expand_kernel_is_the_plain_version(b, e, m0, ef, n, kind,
                                            cuda_device):
    """hop_expand on the card: the plain version's candidates and flags bit
    for bit, one launch a call."""
    adj0, sel, beam = _expand_inputs(b, e, m0, ef, n, cuda_device, kind)
    before = expand.hop_expand.launches
    cand, valid = expand.hop_expand(adj0, sel, beam)
    torch.cuda.synchronize()
    assert expand.hop_expand.launches == before + 1
    want_c, want_v = expand.hop_expand_plain(adj0, sel, beam)
    assert cand.dtype == torch.int32 and valid.dtype == torch.bool
    assert torch.equal(cand, want_c) and torch.equal(valid, want_v)
    if kind != "mixed":
        assert not bool(valid.any())


def test_expand_kernel_refuses_what_it_cannot_take(cuda_device):
    adj0, sel, beam = _expand_inputs(4, 4, 32, 200, 300, cuda_device)
    with pytest.raises(ValueError):          # a CPU / CUDA mix
        expand.hop_expand(adj0, sel.cpu(), beam)
    with pytest.raises(ValueError):          # int64 rows
        expand.hop_expand(adj0, sel.long(), beam)
    with pytest.raises(ValueError):          # a strided beam
        expand.hop_expand(adj0, sel, beam[:, ::2])
    # a beam of 60,000 ids: 240 KB of shared memory, past a block's 227
    wide = torch.full((4, 60_000), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        expand.hop_expand(adj0, sel, wide)


def _merge_inputs(b, ef, c, e, kind, seed=0):
    """tests/test_torch_merge.py's inputs (a beam, candidates and active
    flags of the case `kind`) as CPU tensors."""
    return tuple(torch.from_numpy(a) for a in merge_cases(b, ef, c, e, kind,
                                                          seed))


# (kind, B, ef, C, E): the cells' bodies (ef 200, C = E x M0 = 128) at B =
# 1, 100 and 1,024, and the select before the loop (C = 0) there; then the
# CPU test's cases: ties, -0.0 against 0.0, no valid candidate, multi-entry
# holes with and without candidates, C = 21 with ef = 203, C = 512, fewer
# than E eligible slots, every query stopped, best unexpanded == worst; a
# beam of 1,500 (the prefix in two chunks of 1,024 threads); 1,100
# candidates; a beam of 8,000 (176 KB of shared memory, past the 48 KB
# default)
MERGE_SHAPES = [("mixed", 1, 200, 128, 4), ("mixed", 100, 200, 128, 4),
                ("mixed", 1024, 200, 128, 4), ("mixed", 1024, 200, 0, 4),
                ("ties", 1024, 200, 128, 4), ("signed_zero", 32, 64, 32, 4),
                ("all_big", 100, 200, 128, 4), ("holes", 1024, 200, 0, 4),
                ("holes", 100, 200, 128, 4), ("mixed", 37, 203, 21, 3),
                ("mixed", 16, 200, 512, 4), ("few_eligible", 100, 50, 21, 8),
                ("inactive", 16, 200, 128, 4), ("stop_edge", 16, 40, 16, 4),
                ("mixed", 5, 1500, 64, 4), ("mixed", 5, 64, 1100, 4),
                ("holes", 3, 8000, 128, 4)]


@pytest.mark.parametrize("kind,b,ef,c,e", MERGE_SHAPES)
def test_merge_kernel_is_the_plain_version(kind, b, ef, c, e, cuda_device):
    """hop_merge on the card: the plain version's beam, sel_ids and active
    flags bit for bit (distances as their bits), one launch a call. Held
    against the plain version on the CPU, whose torch.sort the CPU tests
    hold to the contract (-0.0 == 0.0), and, but for -0.0 against 0.0,
    against the plain version on the card."""
    arrays = _merge_inputs(b, ef, c, e, kind, seed=b + ef + c)
    want = merge.hop_merge_plain(*arrays, e)
    on_card = tuple(t.to(cuda_device) for t in arrays)
    before = merge.hop_merge.launches
    got = merge.hop_merge(*on_card, e)
    torch.cuda.synchronize()
    assert merge.hop_merge.launches == before + (1 if b else 0)
    card_plain = merge.hop_merge_plain(*on_card, e)
    for g, w, p in zip(got, want, card_plain):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w, p = (t.view(torch.int32) for t in (g, w, p))
        assert torch.equal(g.cpu(), w)
        if kind != "signed_zero":
            assert torch.equal(g, p)
    if kind == "inactive":
        assert not bool(got[4].any())
    elif kind != "few_eligible":
        assert bool(got[4].any()) and bool((got[3] >= 0).any())


def test_merge_kernel_refuses_what_it_cannot_take(cuda_device):
    arrays = [t.to(cuda_device) for t in _merge_inputs(4, 200, 128, 4,
                                                       "mixed")]
    bad = (("a CPU / CUDA mix", 3, arrays[3].cpu()),
           ("int64 ids", 1, arrays[1].long()),
           ("f64 distances", 0, arrays[0].double()),
           ("a strided beam", 0, arrays[0][:, ::2]),
           ("uint8 flags", 2, arrays[2].to(torch.uint8)),
           ("active of another batch", 5, arrays[5][:3]))
    for _, i, t in bad:
        with pytest.raises(ValueError):
            merge.hop_merge(*arrays[:i], t, *arrays[i + 1:], 4)
    with pytest.raises(ValueError):                # e < 0
        merge.hop_merge(*arrays, -1)
    # a beam of 12,000: 264 KB of shared memory, past a block's 227
    wide = _merge_inputs(2, 12_000, 128, 4, "mixed")
    assert merge.shared_bytes(12_000, 128) == 0
    with pytest.raises(ValueError):
        merge.hop_merge(*(t.to(cuda_device) for t in wide), 4)


def test_merge_kernel_search_is_the_plain_path(cuda_device):
    """At the Bible bulk shape (B = 1,024, E 4, M0 32, ef 200, a bf16 pack,
    sampled entries): a search through the kernel and one through the plain
    operators on the card (the parent's path), both eager with device
    tracing on, give the same rows, distances and hop count and the same
    counters over all 62 bodies: bodies needed, queries active after each
    stop rule, valid slots; the kernel ran once before the loop and once a
    body."""
    from hnsw_tpu_torch.utils import tracing

    data = generate_vectors(6000, 128, distribution="embedding",
                            num_clusters=32, seed=9)
    built = build_hnsw_index(data[:5000], M=16, device=cuda_device)
    idx = HNSWIndex(built.corpus, built.graph, entry_sample=2048,
                    entry_mode="sample", pack_precision="bf16")
    q = idx.corpus.pad_queries(np.concatenate([data[5000:], data[:24]]))
    assert q.shape[0] == 1024 and idx.graph.m0 == 32
    run = idx._search_fn(10, "balanced", None, True)[0]
    kernel = merge.hop_merge

    def plain(*args):
        return merge.hop_merge_plain(*args)

    plain.launches = 0
    outs = []
    for fn in (kernel, plain):
        merge.hop_merge = fn
        before = kernel.launches
        try:
            tracing.enable_device(True)
            tracing.collect()
            d, r, hops = run(q)
            got = tracing.collect()
        finally:
            tracing.enable_device(False)
            merge.hop_merge = kernel
        outs.append((d, r, int(hops), got.counters,
                     kernel.launches - before))
    (kd, kr, kh, kc, kl), (pd, pr, ph, pc, pl) = outs
    max_hops = 200 // 4 + 12
    assert torch.equal(kr, pr) and torch.equal(kd, pd) and kh == ph
    assert (kl, pl) == (max_hops + 1, 0)
    for name in ("hop.bodies_run", "hop.bodies_needed",
                 "hop.query_bodies_active", "hop.slots_scored",
                 "hop.slots_valid"):
        assert kc[name] == pc[name], name
    assert kc["hop.merge_kernel_bodies"] == max_hops
    assert pc["hop.merge_kernel_bodies"] == 0
    assert 0 < kh <= max_hops and bool((kr >= 0).all())


def _gather_inputs(b, c, n, d, dtype, device, seed=0):
    """Unit-norm rows (fmnist's generator) and queries near rows, so
    euclidean distances are small beside the norms; 31% of the slots not
    valid, and a sixth of the queries with none (stopped queries); rows
    clamped to 0 where not valid; norms of the f32 rows, as the search's."""
    g = torch.Generator().manual_seed(seed)
    vectors = torch.nn.functional.normalize(torch.randn(n, d, generator=g),
                                            dim=1)
    queries = vectors[torch.randint(0, n, (b,), generator=g)] + \
        0.05 * torch.randn(b, d, generator=g)
    rows = torch.randint(0, n, (b, c), generator=g, dtype=torch.int32)
    valid = torch.rand(b, c, generator=g) >= 0.31
    valid[torch.rand(b, generator=g) < 1 / 6] = False
    rows = torch.where(valid, rows, 0)
    v_sq = (vectors * vectors).sum(1)
    return tuple(t.to(device) for t in (queries, rows, vectors.to(dtype),
                                        v_sq, valid))


# (B, C, N, D): fmnist's hop body (1,024 queries, E 4 x M0 32 slots, 60,000
# rows of 896 f32 after the corpus's padding); Bible's re-rank (rerank_mult
# 4 x k 10 over 31,173 x 768); the first entry (C = 1); C = 300, past a
# block's 256 slots (two compaction rounds), at pack_dim 112's width; D =
# 4,096 (several passes a lane) and 16,384 (64 KB of f32 query, past the
# 48 KB default of shared memory)
GATHER_SHAPES = [(1024, 128, 60000, 896), (1024, 40, 31173, 768),
                 (100, 1, 500, 768), (37, 300, 2000, 112),
                 (5, 21, 300, 4096), (3, 8, 50, 16384)]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,n,d", GATHER_SHAPES)
def test_gather_kernel_matches_plain_version(b, c, n, d, dtype, metric,
                                             cuda_device):
    """hop_gather_score on the card against its plain version on the card
    (the gather, cuBLAS's f32 product and the mask), one launch a call, with
    int32 and int64 rows. Both sum the same f32 products (bf16 rows: the
    query rounded to bf16, products exact) in other orders, so a dot may
    move by about sqrt(D) x 2^-24 of the sum of |products|, at most
    |q| |v| (Cauchy-Schwarz); 3e-5 |q| |v| holds 4 x sqrt(16,384) x 2^-24.
    Distances: that over |q| |v| for cosine, twice it in d^2 for euclidean
    (whose sqrt loses digits to cancellation, so d^2 is compared), plus the
    epilogue's rounding. BIG exactly where not valid, and nowhere else."""
    queries, rows, vectors, v_sq, valid = _gather_inputs(
        b, c, n, d, dtype, cuda_device, seed=b + c + d)
    q_sq = (queries * queries).sum(1, keepdim=True)
    want = gather.hop_gather_score_plain(queries, rows, vectors, v_sq, metric,
                                         valid, q_sq)
    c_sq = v_sq[rows.long()]
    tol = 3e-5 * torch.sqrt(q_sq * c_sq) * (1.01 if dtype == torch.bfloat16
                                            else 1.0)
    for r in (rows, rows.long()):
        before = gather.hop_gather_score.launches
        got = gather.hop_gather_score(queries, r, vectors, v_sq, metric,
                                      valid, q_sq)
        torch.cuda.synchronize()
        assert gather.hop_gather_score.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (b, c)
        assert torch.equal(got == 1e30, ~valid)
        assert torch.equal(got[~valid], want[~valid])
        g, w = got[valid].double(), want[valid].double()
        t, qc = tol[valid].double(), (q_sq + c_sq)[valid].double()
        if metric == "euclidean":
            err, bar = (g * g - w * w).abs(), 2 * t + 1e-6 * qc
        elif metric == "cosine":
            err = (g - w).abs()
            bar = t / torch.sqrt(torch.clamp((q_sq * c_sq)[valid].double(),
                                             min=1e-12)) + 1e-6
        else:
            err, bar = (g - w).abs(), t + 1e-6
        assert bool((err <= bar).all()), float((err - bar).max())


def test_gather_kernel_allocates_no_candidate_tensor(cuda_device):
    """One hop body's score at fmnist's shape (B 1,024, C 128, D 896, the
    queries' norms given, as the loop gives them): the peak of allocated
    memory is the [B, C] output, under a hundredth of the B x C x D x 4
    bytes that the plain version's gather allocates (which the same
    measurement shows)."""
    b, c, n, d = 1024, 128, 60000, 896
    queries, rows, vectors, v_sq, valid = _gather_inputs(
        b, c, n, d, torch.float32, cuda_device)
    q_sq = (queries * queries).sum(1, keepdim=True)
    peaks = []
    for fn in (gather.hop_gather_score, gather.hop_gather_score_plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(queries, rows, vectors, v_sq, "euclidean", valid, q_sq)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    assert peaks[0] < b * c * d * 4 / 100
    assert peaks[1] >= b * c * d * 4


def test_gather_kernel_refuses_what_it_cannot_take(cuda_device):
    queries, rows, vectors, v_sq, valid = _gather_inputs(
        4, 8, 300, 128, torch.float32, cuda_device)
    q_sq = (queries * queries).sum(1, keepdim=True)
    good = [queries, rows, vectors, v_sq, valid, q_sq]
    # rows of 110 f32 values: not whole 16-byte chunks
    narrow = {0: queries[:, :110].contiguous(),
              2: torch.zeros((300, 110), device=cuda_device)}
    bad = (("a CPU / CUDA mix", {1: rows.cpu()}),
           ("f64 queries", {0: queries.double()}),
           ("f16 rows", {2: vectors.half()}),
           ("int16 ids", {1: rows.short()}),
           ("uint8 flags", {4: valid.to(torch.uint8)}),
           ("flags of another shape", {4: valid[:, :3]}),
           ("rows of another width", {2: vectors[:, :64].contiguous()}),
           ("strided ids", {1: rows[:, ::2]}),
           ("norms of another batch", {5: q_sq[:3]}),
           ("rows of 110 f32", narrow))
    for what, swap in bad:
        args = [swap.get(i, t) for i, t in enumerate(good)]
        with pytest.raises(ValueError):
            gather.hop_gather_score(*args[:4], "cosine", *args[4:])
    # a query of 60,000 f32 (240 KB): past a block's shared memory
    assert gather.shared_bytes(60_000, 4) == 0
    assert gather.shared_bytes(896, 4) > 0


def test_gather_kernel_euclidean_search_is_the_plain_path(cuda_device):
    """An f32 euclidean search (no shadow, no pack, as fmnist's) at B =
    1,024: replayed from its captured CUDA graph, whose every body's score
    and the first entry's are the kernel, against the eager search with the
    plain operators on the card (the parent's path). The two differ only in
    the order of f32 sums, so rows are the same but where neighbours tie
    within that rounding: the distance lists agree slot by slot within
    1e-5, rows are identical for >= 99% of queries, and recall@10 against
    the exact flat index is the same within 1e-3."""
    data = generate_vectors(7024, 256, distribution="embedding",
                            num_clusters=32, seed=11)
    built = build_hnsw_index(data[:6000], M=16, metric="euclidean",
                             device=cuda_device)
    idx = HNSWIndex(built.corpus, built.graph, entry_mode="sample")
    q = idx.corpus.pad_queries(data[6000:])
    assert q.shape[0] == 1024
    _, truth = FlatIndex(idx.corpus).search_batch(q, 10)
    kd, kr = idx.search_batch(q, 10, "balanced")
    (call,) = idx._graphs.values()
    max_hops = 200 // 4 + 12
    assert (gather.hop_gather_score, max_hops + 1) in call.launches
    kernel = gather.hop_gather_score

    def plain(*args):
        return gather.hop_gather_score_plain(*args)

    plain.launches = 0
    gather.hop_gather_score = plain
    try:
        pd, pr, _ = idx._search_fn(10, "balanced", None, False)[0](q)
    finally:
        gather.hop_gather_score = kernel
    assert bool((kr >= 0).all()) and bool((pr >= 0).all())
    assert float((kr == pr).all(dim=1).float().mean()) >= 0.99
    torch.testing.assert_close(kd, pd, rtol=0, atol=1e-5)
    assert abs(recall(kr, truth) - recall(pr, truth)) <= 1e-3
    assert recall(kr, truth) >= 0.9


def _descent_inputs(d, m, dtype, metric, device, duplicates=False):
    """A random 3-layer upper graph over 2,000 rows (a tenth of its slots
    empty), 300 queries near corpus rows, each walk starting at a random
    row and its distance. duplicates: every row one of 50 vectors, so
    neighbourhoods hold exact ties."""
    g = torch.Generator(device="cpu").manual_seed(d * 31 + m)
    n, b, layers = 2000, 300, 3
    base = torch.randn(n, d, generator=g)
    if duplicates:
        base = base[torch.randint(0, 50, (n,), generator=g)]
    if metric == "cosine":
        base = torch.nn.functional.normalize(base, dim=1)
    adj = torch.randint(0, n, (layers, n, m), generator=g, dtype=torch.int32)
    adj[torch.rand(adj.shape, generator=g) < 0.1] = -1
    q = base[torch.randint(0, n, (b,), generator=g)] + \
        0.3 * torch.randn(b, d, generator=g)
    cur = torch.randint(0, n, (b,), generator=g, dtype=torch.int32)
    v_sq = (base * base).sum(1)
    vectors = base.to(dtype)
    q, cur, adj, vectors, v_sq = (t.to(device) for t in (q, cur, adj, vectors,
                                                          v_sq))
    q_sq = (q * q).sum(1)
    d0 = descent.shadow_score(q, cur[:, None].long(), vectors, v_sq, metric,
                              torch.ones((b, 1), dtype=torch.bool,
                                         device=device))[:, 0]
    return q, q_sq, cur, d0, adj, vectors, v_sq


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,m,dup", [(64, 8, False), (128, 16, False),
                                     (768, 16, False), (128, 16, True),
                                     (768, 32, False), (128, 10, False),
                                     (2064, 16, False), (64, 200, False),
                                     (16, 16, False)])
def test_descent_kernel_matches_plain_version(d, m, dup, dtype, metric,
                                              cuda_device):
    """The walk's endpoints agree with the plain batch loop for >= 0.99 of
    queries (f32 sums in another order can flip only near-ties; exact ties
    of duplicate rows go to the first neighbour in both), and the distances
    where they agree to 1e-5 of the largest; one launch a call. M = 10
    moves its ids 4 bytes at a time; D = 2,064 holds no chunk of the query
    in registers (a chunk a pass); M = 200 fetches the next step's ids
    after the argmin (csrc/descent.cu:make_plan); D = 16 leaves lanes of a
    row idle."""
    args = _descent_inputs(d, m, dtype, metric, cuda_device, dup)
    before = descent.greedy_descent.launches
    kc, kd = descent.greedy_descent(*args, metric)
    assert descent.greedy_descent.launches == before + 1
    pc, pd = descent.greedy_descent_plain(*args, metric)
    same = kc == pc
    assert float(same.float().mean()) >= 0.99
    assert bool((kc != args[2]).any())
    scale = float(pd.abs().max())
    assert float((kd - pd)[same].abs().max()) <= 1e-5 * max(scale, 1.0)
    kc2, kd2 = descent.greedy_descent(*args, metric)
    assert torch.equal(kc, kc2) and torch.equal(kd, kd2)


def test_descent_kernel_refuses_what_it_cannot_take(cuda_device):
    q, q_sq, cur, d0, adj, vectors, v_sq = _descent_inputs(
        64, 8, torch.bfloat16, "cosine", cuda_device)
    with pytest.raises(ValueError):          # int64 rows
        descent.greedy_descent(q, q_sq, cur.long(), d0, adj, vectors, v_sq,
                               "cosine")
    with pytest.raises(ValueError):          # rows of 12 bytes
        descent.greedy_descent(q[:, :6].contiguous(), q_sq, cur, d0, adj,
                               vectors[:, :6].contiguous(), v_sq, "cosine")
    # M = 10,000: two buffers of its keys and ids alone pass the shared
    # memory of a block
    wide = torch.zeros((1, vectors.shape[0], 10_000), dtype=torch.int32,
                       device=adj.device)
    with pytest.raises(ValueError):
        descent.greedy_descent(q, q_sq, cur, d0, wide, vectors, v_sq,
                               "cosine")


def _launches():
    return [w.launches for w in kernel_wrappers()]


def test_search_is_captured_in_one_cuda_graph(cuda_device):
    """hnsw_search_batch (the entry() twin: hierarchy descent, no pack)
    captured whole in one CUDA graph: capturing counts no launch, each
    replay adds the launches the graph holds (the descent, the expand
    kernel once a body, the merge kernel once before the loop and once a
    body), and two replays with other queries each give the
    rows and distances of their eager runs, the first result untouched by
    the second replay."""
    fn, args = entry()
    run = lambda q: fn(*args[:5], q)                     # noqa: E731
    q1 = args[5]
    q2 = torch.flip(q1, dims=[0]).contiguous()
    e1, e2 = run(q1), run(q2)
    before = _launches()
    call = CapturedCall(run, q1)
    max_hops = 64 // 4 + 12
    # the gather-score kernel: the first entry, every body (an f32 loop
    # with no pack) and the re-rank
    assert call.launches == [(expand.hop_expand, max_hops),
                             (merge.hop_merge, max_hops + 1),
                             (gather.hop_gather_score, max_hops + 2),
                             (descent.greedy_descent, 1)]
    warm = [a - b for a, b in zip(_launches(), before)]  # the eager warm-up
    r1 = call(q1)
    r2 = call(q2)
    after = [a - b - w for a, b, w in zip(_launches(), before, warm)]
    per_replay = dict(call.launches)
    assert after == [2 * per_replay.get(w, 0) for w in kernel_wrappers()]
    for got, want in ((r1, e1), (r2, e2)):
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("entry_mode,pp", [("sample", "bf16"),
                                           ("hierarchy", "int8")])
def test_hnsw_index_replays_its_captured_search(entry_mode, pp, cuda_device):
    """HNSWIndex.search_batch replays a graph captured at its first call of
    a shape: rows and hop counts those of the eager sync-free search, a
    replay adds max_hops hop kernel launches (and one descent), and
    add_batch drops the graphs, after which a new capture gives the eager
    search's rows on the grown graph."""
    data = generate_vectors(3000, 128, distribution="embedding",
                            num_clusters=16, seed=5)
    built = build_hnsw_index(data[:2900], M=16, device=cuda_device)
    idx = HNSWIndex(built.corpus, built.graph, entry_mode=entry_mode,
                    pack_precision=pp)
    qs = [idx.corpus.pad_queries(data[i:i + 64]) for i in (0, 64)]
    run, _ = idx._search_fn(10, "balanced", None, True)
    eager = [run(q) for q in qs]
    outs = [idx.search_batch(q, 10, "balanced", debug_hops=True) for q in qs]
    assert len(idx._graphs) == 1
    kernel = hop.hop_score_int8 if pp == "int8" else hop.hop_score
    before = (kernel.launches, descent.greedy_descent.launches)
    d, r, hops = idx.search_batch(qs[0], 10, "balanced", debug_hops=True)
    max_hops = 200 // 4 + 12
    assert (kernel.launches - before[0],
            descent.greedy_descent.launches - before[1]) == (
        max_hops, int(entry_mode == "hierarchy"))
    for (gd, gr, gh), (ed, er, eh) in zip(outs, eager):
        assert torch.equal(gr, er) and torch.equal(gd, ed) and gh == int(eh)
    assert torch.equal(r, outs[0][1]) and 0 < hops <= max_hops
    idx.add_batch(data[2900:])
    assert len(idx._graphs) == 0
    # a new capture searches the grown graph: the eager search's rows
    q = idx.corpus.pad_queries(data[2900:2964])
    d, r = idx.search_batch(q, 10, "balanced")
    ed, er, _ = idx._search_fn(10, "balanced", None, False)[0](q)
    assert torch.equal(r, er) and torch.equal(d, ed)


@pytest.fixture(scope="module")
def lowdim_graph():
    """A 3,000 x 256 graph with upper layers, built once on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = generate_vectors(3000, 256, distribution="embedding",
                            num_clusters=16, seed=5)
    return data, build_hnsw_index(data, device="cuda").to_state()


@pytest.mark.parametrize("entry_mode", ["sample", "hierarchy"])
@pytest.mark.parametrize("pp", ["bf16", "int8"])
@pytest.mark.parametrize("pack_dim", [100, 120])
def test_pack_dim_off_16_searches_on_the_card(pack_dim, pp, entry_mode,
                                              lowdim_graph):
    """A pack_dim that is not a multiple of 16: the projection is widened
    with zero columns to one (the hop kernels and the descent take no
    other width), and the captured search's rows are the CPU's."""
    data, state = lowdim_graph
    kw = dict(pack_dim=pack_dim, pack_precision=pp, entry_mode=entry_mode)
    gpu, cpu = (HNSWIndex.from_state(Corpus.from_array(data, device=dev),
                                     state, **kw) for dev in ("cuda", "cpu"))
    kernel = hop.hop_score_int8 if pp == "int8" else hop.hop_score
    before = (kernel.launches, descent.greedy_descent.launches)
    gd, gr = gpu.search_batch(data[:256], 10, "balanced")
    assert kernel.launches > before[0]
    assert (descent.greedy_descent.launches > before[1]) == (
        entry_mode == "hierarchy")
    assert gpu._shadow.nbr_pack.shape[2] == -(-pack_dim // 16) * 16
    cd, cr = cpu.search_batch(data[:256], 10, "balanced")
    same = (gr.cpu() == cr).all(dim=1)
    assert same.float().mean() >= 0.99
    np.testing.assert_allclose(gd.cpu()[same], cd[same], atol=1e-5)


def _small_card_index(cuda_device, **kw):
    data = generate_vectors(3000, 128, distribution="embedding",
                            num_clusters=16, seed=5)
    built = build_hnsw_index(data[:2900], M=16, device=cuda_device)
    idx = HNSWIndex(built.corpus, built.graph, **kw)
    return idx, idx.corpus.pad_queries(data[2900:2964])


def test_untraced_capture_launches_what_it_did(cuda_device):
    """Device tracing off, the captured search holds the hand-written
    kernels it held before the tracer (max_hops hop launches, max_hops
    expand launches, max_hops + 1 merge launches, and two gather-score
    launches, the first entry's and the re-rank's; no mark); on, the same,
    and the marks: the entry, the select and a count before the loop, four
    a body (expand, score, merge, count), the re-rank and the end."""
    from hnsw_tpu_torch.utils import tracing

    idx, q = _small_card_index(cuda_device)
    max_hops = 200 // 4 + 12
    tracing.enable_device(False)
    idx.search_batch(q, 10, "balanced")
    (call,) = idx._graphs.values()
    assert call.launches == [(hop.hop_score, max_hops),
                             (expand.hop_expand, max_hops),
                             (merge.hop_merge, max_hops + 1),
                             (gather.hop_gather_score, 2)]
    try:
        tracing.enable_device(True)
        idx.search_batch(q, 10, "balanced")
    finally:
        tracing.enable_device(False)
        tracing.collect()
    traced = list(idx._graphs.values())[-1]
    assert len(idx._graphs) == 2
    assert traced.launches == [(hop.hop_score, max_hops),
                               (expand.hop_expand, max_hops),
                               (merge.hop_merge, max_hops + 1),
                               (gather.hop_gather_score, 2),
                               (tracing.stamp, 5 + 4 * max_hops)]


@pytest.mark.parametrize("entry_mode", ["sample", "hierarchy"])
def test_traced_capture_phases_sum_to_its_replays(entry_mode, cuda_device):
    """A graph captured with device tracing, replayed ten times back to
    back: its phases, summed over the replays, within 3% of the replays'
    time (two CUDA events around them on the stream; the host queues the
    next replay before the card ends the last, and the first mark opens
    each graph, the last closes it); the rows those of the untraced graph;
    the counters' bodies needed debug_hops's trip count; each share within
    its base."""
    from hnsw_tpu_torch.utils import tracing

    idx, q = _small_card_index(cuda_device, entry_mode=entry_mode)
    d0, r0, hops = idx.search_batch(q, 10, "balanced", debug_hops=True)
    reps = 10
    try:
        tracing.enable_device(True)
        idx.search_batch(q, 10, "balanced")
        tracing.collect()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            d1, r1 = idx.search_batch(q, 10, "balanced")
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        got = tracing.collect()
    finally:
        tracing.enable_device(False)
    assert torch.equal(r0, r1) and torch.equal(d0, d1)
    assert got.runs == reps
    phases = sum(got.phase_ms.values())
    assert abs(phases - ms) <= 0.03 * ms, (phases, ms, got.phase_ms)
    assert all(got.phase_ms[p] > 0 for p in tracing.PHASES
               if p != "dequant")
    assert got.phase_ms["dequant"] == 0   # the int8 pack's phase alone
    c = got.counters
    max_hops = 200 // 4 + 12
    assert c["hop.bodies_run"] == reps * max_hops
    assert c["hop.bodies_needed"] == reps * hops
    assert 0 < c["hop.query_bodies_active"] <= 64 * c["hop.bodies_run"]
    assert c["hop.slots_scored"] == reps * max_hops * 64 * 4 * idx.graph.m0
    assert 0 < c["hop.slots_valid"] <= c["hop.slots_scored"]
    assert c["hop.expand_kernel_bodies"] == c["hop.bodies_run"]
    assert c["hop.merge_kernel_bodies"] == c["hop.bodies_run"]
    # the bf16 pack's kernel scores every body
    assert c["hop.score_kernel_bodies"] == 0


def test_int8_pack_at_d_pad_128_is_captured_and_replayed(cuda_device,
                                                         monkeypatch):
    """glove-100-angular's route at a small size: a 6,000 x 100 cosine
    index (D_pad 128) whose pack cap lies between the int8 and the bf16
    pack's bytes, so that "auto" picks int8, searched at B = 1,024 from its
    captured CUDA graph: max_hops launches of B2 a replay; rows those of the
    same graph searched on the CPU for >= 99% of queries (B2 and its plain
    version sum in another order, which can swap near ties), distances
    within 1e-5 where the rows agree; B2 at the served shape (the pack, the
    queries, B = 1,024 x E = 4 selected rows with -1s) within 1e-4 of the
    largest plain dot. With device tracing on, the traced graph's dequant
    phase reads > 0, and it marks once more a body."""
    from hnsw_tpu_torch.models.hnsw.shadow import HopShadow
    from hnsw_tpu_torch.utils import tracing

    data = generate_vectors(7024, 100, distribution="embedding",
                            num_clusters=32, seed=23)
    built = build_hnsw_index(data[:6000], M=16, max_M0=32,
                             device=cuda_device)
    slots = built.graph.adj0.shape[0] * built.graph.adj0.shape[1]
    monkeypatch.setitem(HopShadow.prepare.__kwdefaults__, "cap",
                        slots * (128 + 8 + 128 * 2 + 4) // 2)
    state = built.to_state()
    gpu, cpu = (HNSWIndex.from_state(Corpus.from_array(data[:6000],
                                                       device=dev), state)
                for dev in ("cuda", "cpu"))
    q = data[6000:]
    assert len(q) == 1024
    kd, kr = gpu.search_batch(q, 10, "balanced")
    assert gpu._shadow.nbr_pack.dtype == torch.int8
    assert gpu._shadow.nbr_pack.shape[1:] == (32, 128)
    (call,) = gpu._graphs.values()
    max_hops = 200 // 4 + 12
    assert (hop.hop_score_int8, max_hops) in call.launches
    before = hop.hop_score_int8.launches
    kd, kr = gpu.search_batch(q, 10, "balanced")
    assert hop.hop_score_int8.launches - before == max_hops
    cd, cr = cpu.search_batch(q, 10, "balanced")
    assert cpu._shadow.nbr_pack.dtype == torch.int8
    same = (kr.cpu() == cr).all(dim=1)
    assert same.float().mean() >= 0.99
    np.testing.assert_allclose(kd.cpu()[same], cd[same], atol=1e-5)

    g = torch.Generator(device="cpu").manual_seed(5)
    pack = gpu._shadow.nbr_pack
    sel = torch.randint(-1, pack.shape[0], (1024, 4), generator=g,
                        dtype=torch.int32).to(cuda_device)
    qk = gpu.corpus.pad_queries(q).float().contiguous()
    got = hop.hop_score_int8(pack, qk, sel)
    want = hop.hop_score_int8_plain(pack, qk, torch.clamp(sel, min=0))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

    try:
        tracing.enable_device(True)
        gpu.search_batch(q, 10, "balanced")
        tracing.collect()
        gpu.search_batch(q, 10, "balanced")
        traced = tracing.collect()
    finally:
        tracing.enable_device(False)
        tracing.collect()
    assert traced.runs == 1 and traced.phase_ms["dequant"] > 0
    assert (tracing.stamp, 5 + 5 * max_hops) in \
        list(gpu._graphs.values())[-1].launches

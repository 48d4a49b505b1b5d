"""The search's candidate scoring against rows (hnsw_tpu_torch/ops/gather.py)
on the CPU: the plain version against a loop written out on the kernel's
contract, shadow_score against the operators it ran before, models of
csrc/gather.cu's two plans (the block plan's compaction rounds and lanes'
chunks; the warp plan's reads, halvings and stores, and the width that
picks it) against the contract, the wrapper's CPU route and refusals, and the
counter of hop bodies whose score ran the kernel. No JAX; the kernel itself
runs in tests/test_torch_gpu.py on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import build_hnsw_index
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.ops import gather
from hnsw_tpu_torch.ops.distance import BIG, _dist_bc, shadow_score
from hnsw_tpu_torch.utils import tracing

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "hnsw_tpu_torch"
          / "csrc" / "gather.cu").read_text()
METRICS = ["cosine", "euclidean", "dot"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def inputs(b, c, n, d, dtype, seed, invalid=0.31):
    """Queries and rows near each other (so euclidean distances are small
    beside the norms), rows clamped to 0 where a slot is not valid, a query
    with no valid slot (a stopped query) and one with every slot valid."""
    g = torch.Generator().manual_seed(seed)
    vectors = torch.randn(n, d, generator=g)
    queries = vectors[torch.randint(0, n, (b,), generator=g)] + \
        0.1 * torch.randn(b, d, generator=g)
    rows = torch.randint(0, n, (b, c), generator=g, dtype=torch.int32)
    valid = torch.rand(b, c, generator=g) >= invalid
    valid[0] = False
    if b > 1:
        valid[1] = True
    rows = torch.where(valid, rows, 0)
    v_sq = (vectors * vectors).sum(1)
    return queries, rows, vectors.to(dtype), v_sq, valid


def contract(queries, rows, vectors, v_sq, metric, valid):
    """The contract as a loop over queries and slots, in float64: the query
    rounded to the rows' dtype, BIG where not valid."""
    q = queries.to(vectors.dtype).double().numpy()
    q_sq = (queries.double() ** 2).sum(1).numpy()
    v = vectors.double().numpy()
    vs = v_sq.double().numpy()
    b_n, c_n = rows.shape
    out = np.empty((b_n, c_n))
    for b in range(b_n):
        for s in range(c_n):
            if not valid[b, s]:
                out[b, s] = BIG
                continue
            r = int(rows[b, s])
            dot = float(q[b] @ v[r])
            if metric == "cosine":
                out[b, s] = 1.0 - dot / np.sqrt(max(q_sq[b] * vs[r], 1e-12))
            elif metric == "euclidean":
                out[b, s] = np.sqrt(max(q_sq[b] + vs[r] - 2.0 * dot, 0.0))
            else:
                out[b, s] = -dot
    return out, q_sq


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,n,d", [(7, 13, 50, 32), (5, 128, 300, 112),
                                     (3, 1, 10, 16)])
def test_plain_version_is_the_contract(b, c, n, d, dtype, metric):
    """Within f32 rounding of a float64 loop: dots within 1e-5 of the sum of
    |products| (cosine and dot), euclidean compared squared within 1e-5 of
    q_sq + c_sq, where its sqrt loses digits to cancellation; BIG exactly
    where not valid and nowhere else."""
    x = inputs(b, c, n, d, dtype, seed=b * 100 + c + d)
    queries, rows, vectors, v_sq, valid = x
    got = gather.hop_gather_score_plain(queries, rows, vectors, v_sq, metric,
                                        valid)
    want, q_sq = contract(*x[:4], metric, valid)
    assert got.dtype == torch.float32 and got.shape == (b, c)
    assert torch.equal(got == BIG, ~valid)
    g = got.double().numpy()[valid.numpy()]
    w = want[valid.numpy()]
    r = rows.long()[valid]
    q_r = queries.to(dtype).double()[torch.nonzero(valid)[:, 0]]
    mag = (q_r.abs() * vectors.double()[r].abs()).sum(1).numpy()
    if metric == "euclidean":
        scale = q_sq[torch.nonzero(valid)[:, 0].numpy()] + \
            v_sq.double()[r].numpy()
        np.testing.assert_array_less(np.abs(g ** 2 - w ** 2), 1e-5 * scale)
    elif metric == "cosine":
        norm = np.sqrt(q_sq[torch.nonzero(valid)[:, 0].numpy()]
                       * v_sq.double()[r].numpy())
        np.testing.assert_array_less(np.abs(g - w), 1e-5 * mag / norm + 1e-6)
    else:
        np.testing.assert_array_less(np.abs(g - w), 1e-5 * mag + 1e-6)


def old_shadow_score(queries, rows, vectors, v_sq, metric, valid, q_sq=None):
    """ops/distance.py:shadow_score's operators as they were."""
    cand = vectors[rows]
    qc = queries.to(cand.dtype).float()
    dots = torch.einsum("bd,bcd->bc", qc, cand.float())
    if q_sq is None:
        q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    d = _dist_bc(dots, q_sq, v_sq[rows], metric)
    return torch.where(valid, d, BIG)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("given_q_sq", [False, True])
def test_shadow_score_on_the_cpu_is_what_it_was(metric, dtype, given_q_sq):
    """Bit for bit, with the queries' norms given or not, and with int64
    rows (the card's callers pass both)."""
    queries, rows, vectors, v_sq, valid = inputs(9, 40, 200, 64, dtype,
                                                 seed=7)
    q_sq = (queries * queries).sum(1, keepdim=True) if given_q_sq else None
    before = gather.hop_gather_score.launches
    for r in (rows, rows.long()):
        got = shadow_score(queries, r, vectors, v_sq, metric, valid, q_sq)
        want = old_shadow_score(queries, r, vectors, v_sq, metric, valid,
                                q_sq)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert gather.hop_gather_score.launches == before


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x = inputs(6, 21, 60, 48, torch.bfloat16, seed=3)
    before = gather.hop_gather_score.launches
    got = gather.hop_gather_score(*x[:4], "euclidean", x[4])
    want = gather.hop_gather_score_plain(*x[:4], "euclidean", x[4])
    assert gather.hop_gather_score.launches == before
    assert torch.equal(got, want)


def test_check_refuses_what_the_kernel_cannot_take():
    """CPU tensors, a mix with another device, and on the CPU every dtype
    and shape, are refused before any pointer is passed (the card test
    refuses dtypes, shapes, strides and widths on the card)."""
    queries, rows, vectors, v_sq, valid = inputs(4, 8, 30, 32,
                                                 torch.float32, seed=1)
    q_sq = (queries * queries).sum(1, keepdim=True)
    with pytest.raises(ValueError):
        gather._check(queries, rows, vectors, v_sq, valid, q_sq)
    with pytest.raises(ValueError):
        gather._check(queries.double(), rows, vectors, v_sq, valid, q_sq)
    with pytest.raises(ValueError):
        gather._check(queries, rows[:, :3], vectors, v_sq, valid, q_sq)
    with pytest.raises(ValueError):
        gather.hop_gather_score(queries, rows, vectors.to("meta"), v_sq,
                                "cosine", valid)
    with pytest.raises(ValueError):
        gather.hop_gather_score(queries, rows, vectors, v_sq, "cosine",
                                valid, q_sq.to("meta"))


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} is not where this test reads it"
    return int(m.group(1))


def plan(d, value_bytes):
    """csrc/gather.cu's launch plan: (lanes a row, rows a warp-step, chunks
    a lane a pass, passes)."""
    chunks = d * value_bytes // 16
    lanes_log = 0
    while (1 << lanes_log) < chunks and lanes_log < 5:
        lanes_log += 1
    lanes = 1 << lanes_log
    per_lane = -(-chunks // lanes)
    nc = 1 if per_lane <= 1 else 2 if per_lane <= 2 else \
        4 if per_lane <= 4 else 8
    return chunks, lanes, 32 // lanes, nc, -(-per_lane // nc)


@pytest.mark.parametrize("d,value_bytes", [(896, 4), (768, 4), (256, 4),
                                           (128, 4), (16, 4), (768, 2),
                                           (112, 2), (256, 2), (16, 2),
                                           (4096, 4), (1000, 4)])
def test_kernel_plan_reads_every_chunk_once(d, value_bytes):
    """Every 16-byte chunk of a row by one lane of its group, once, over the
    passes; a group's lanes within one warp."""
    chunks, lanes, rows_a_step, nc, passes = plan(d, value_bytes)
    assert lanes * rows_a_step == 32
    seen = np.zeros(chunks, int)
    for sub in range(lanes):
        for ps in range(passes):
            for i in range(nc):
                c = sub + (ps * nc + i) * lanes
                if c < chunks:
                    seen[c] += 1
    assert (seen == 1).all()
    if d == 896 and value_bytes == 4:
        assert (lanes, nc, passes) == (32, 8, 1)


@pytest.mark.parametrize("c", [1, 13, 128, 256, 300, 1100])
def test_kernel_compaction_places_every_slot_once(c):
    """The ballot prefix, kThreads slots a round: each valid slot at its
    rank among the round's valid slots, in slot order (warp counts, then
    the lanes below), and each slot written once: BIG by its own thread or
    its distance by the lane that scores its place."""
    threads = _source_int("kThreads")
    rng = np.random.default_rng(c)
    valid = rng.random(c) >= 0.31
    written = np.zeros(c, int)
    for base in range(0, c, threads):
        s = base + np.arange(threads)
        v = (s < c) & valid[np.minimum(s, c - 1)]
        warp_n = v.reshape(-1, 32).sum(1)
        place = np.zeros(threads, int)
        for t in np.nonzero(v)[0]:
            w, lane = divmod(t, 32)
            place[t] = warp_n[:w].sum() + v[w * 32:w * 32 + lane].sum()
        listed = np.full(v.sum(), -1)
        listed[place[v]] = s[v]
        assert (np.diff(listed) > 0).all() and (listed >= 0).all()
        written[listed] += 1
        written[s[(s < c) & ~v]] += 1
    assert (written == 1).all()


def warp_plan(d, value_bytes):
    """csrc/gather.cu's warp plan where a row is at most kWarpChunks chunks:
    (chunks, lanes a row, rows a warp-step, warp-steps a batch, batches);
    None where the block plan takes the row."""
    chunks = d * value_bytes // 16
    if chunks > _source_int("kWarpChunks"):
        return None
    lanes = 1
    while lanes < chunks:
        lanes *= 2
    steps = min(lanes, _source_int("kWarpSteps"))
    return chunks, lanes, 32 // lanes, steps, lanes // steps


def nth_set_bit(mask, j):
    """gather.cu's nth_set_bit: a binary search over popcounts."""
    pos, w = 0, 16
    while w:
        low = bin(mask & ((1 << w) - 1)).count("1")
        if j >= low:
            j, mask, pos = j - low, mask >> w, pos + w
        w //= 2
    return pos


def halve(vals, off):
    """gather.cu's halve<V, OFF> over the warp's lanes: vals [32, V] ->
    (v[0] of each lane, shuffles a lane)."""
    v, lanes = vals.copy(), np.arange(32)
    half, shuffles = v.shape[1] // 2, 0
    while half:
        upper = ((lanes & (off * half)) != 0)[:, None]
        send = np.where(upper, v[:, :half], v[:, half:2 * half])
        keep = np.where(upper, v[:, half:2 * half], v[:, :half])
        v = keep + send[lanes ^ (off * half)]
        shuffles += half
        half //= 2
    return v[:, 0], shuffles


def run_warp_plan(valid, rows, q, vectors, plan):
    """gather_score_kernel_warp over one query's C slots, warp by warp, lane
    by lane (valid [C], rows [C], q [chunks, V], vectors [N, chunks, V]):
    the value written to each slot (None for BIG), the writes a slot, the
    (warp, slot, chunk) of every row read, and the reductions' shuffles a
    warp."""
    chunks, lanes_n, r_, steps, batches = plan
    c = len(valid)
    lane = np.arange(32)
    p, sub = lane & (r_ - 1), lane // r_
    out, written, reads, shuffles = [None] * c, np.zeros(c, int), [], []
    for seg in range(-(-c // 32)):
        s = seg * 32 + lane
        v = (s < c) & valid[np.minimum(s, c - 1)]
        r = np.where(s < c, rows[np.minimum(s, c - 1)], 0)
        ballot = sum(1 << int(t) for t in np.nonzero(v)[0])
        n = bin(ballot).count("1")
        row_j = r[[nth_set_bit(ballot, t) for t in range(32)]]
        part = np.zeros((32, batches))
        count = 0
        for nb in range(batches):
            if nb * steps * r_ >= n:
                continue
            acc = np.zeros((32, steps))
            for g in range(steps):
                j = (nb * steps + g) * r_ + p
                for t in np.nonzero((j < n) & (sub < chunks))[0]:
                    reads.append((seg, seg * 32 + nth_set_bit(ballot, j[t]),
                                  sub[t]))
                    acc[t, g] = q[sub[t]] @ vectors[row_j[j[t]], sub[t]]
            part[:, nb], k = halve(acc, r_)
            count += k
        total, k = halve(part, r_ * steps)
        shuffles.append(count + k)
        for t in np.nonzero(s < c)[0]:
            rank = bin(ballot & ((1 << int(t)) - 1)).count("1")
            out[s[t]] = total[rank] if v[t] else None
            written[s[t]] += 1
    return out, written, reads, shuffles


@pytest.mark.parametrize("d,value_bytes", [(16, 4), (64, 4), (128, 4),
                                           (16, 2), (112, 2), (256, 2)])
@pytest.mark.parametrize("c", [1, 13, 32, 128, 300])
def test_warp_plan_scores_each_slot_once(c, d, value_bytes):
    """The warp plan on integer values (sums exact in float64): each valid
    slot's chunks read exactly once, by the warp that owns the slot, and no
    row of a slot that is not valid; lane j holding the j-th valid row's
    sum after the halvings, L - 1 shuffles of them a warp that scores
    every batch; each slot written once, BIG exactly where not valid."""
    plan = warp_plan(d, value_bytes)
    chunks, lanes_n = plan[:2]
    rng = np.random.default_rng(c * 1000 + d * value_bytes)
    n_rows, per_chunk = 50, 16 // value_bytes
    vectors = rng.integers(-8, 9, (n_rows, chunks, per_chunk)).astype(float)
    q = rng.integers(-8, 9, (chunks, per_chunk)).astype(float)
    valid = rng.random(c) >= 0.31
    valid[32:64] = False          # a warp with no valid slot
    valid[64:96] = True           # and one with every slot valid
    rows = np.where(valid, rng.integers(0, n_rows, c), 0)
    out, written, reads, shuffles = run_warp_plan(valid, rows, q, vectors,
                                                  plan)
    assert (written == 1).all()
    for s in range(c):
        want = (q * vectors[rows[s]]).sum() if valid[s] else None
        assert out[s] == want, s
    seen = {}
    for seg, s, chunk in reads:
        assert valid[s] and seg == s // 32
        seen[(s, chunk)] = seen.get((s, chunk), 0) + 1
    assert sorted(seen) == [(s, k) for s in np.nonzero(valid)[0]
                            for k in range(chunks)]
    assert set(seen.values()) <= {1}
    if c >= 96:
        assert shuffles[2] == lanes_n - 1


@pytest.mark.parametrize("d,value_bytes", [(896, 4), (768, 4), (256, 4),
                                           (132, 4), (128, 4), (64, 4),
                                           (16, 4), (768, 2), (264, 2),
                                           (256, 2), (112, 2), (16, 2)])
def test_launcher_picks_the_plan_by_width(d, value_bytes):
    """The warp plan at rows of at most 32 chunks (f32 D <= 128, bf16
    D <= 256), the block plan above, with fmnist's D 896 on (32 lanes, NC 8,
    one pass) as before; the launcher tests the same bound."""
    assert "if (chunks <= kWarpChunks) {" in SOURCE
    narrow = d * value_bytes <= 512
    assert (warp_plan(d, value_bytes) is not None) == narrow
    if narrow:
        chunks, lanes_n, r_, steps, batches = warp_plan(d, value_bytes)
        assert lanes_n * r_ == 32 and steps * batches == lanes_n
        assert chunks <= lanes_n < 2 * chunks
    if (d, value_bytes) == (896, 4):
        _, lanes_n, _, nc, passes = plan(d, value_bytes)
        assert (lanes_n, nc, passes) == (32, 8, 1)
    if (d, value_bytes) == (128, 4):
        assert warp_plan(d, value_bytes) == (32, 32, 1, 8, 4)


@pytest.fixture(scope="module")
def small_indexes():
    data = generate_vectors(700, 32, distribution="embedding",
                            num_clusters=8, seed=3)
    return {metric: build_hnsw_index(data[:600], M=8, metric=metric,
                                     device="cpu")
            for metric in ("euclidean", "cosine")}, data[600:632]


@pytest.mark.parametrize("metric,kernel", [("euclidean", False),
                                           ("euclidean", True),
                                           ("cosine", True)])
def test_counter_counts_the_bodies_whose_score_launched_the_kernel(
        metric, kernel, small_indexes, monkeypatch):
    """The card's fixed-length loop, forced on the CPU: with the plain
    version no body counts; with a stand-in kernel (the plain version that
    counts a launch) every body of the f32 euclidean loop does, the seed's
    and the re-rank's launches not counted, and the rows are the same; the
    cosine loop scores against its bf16 pack, so none does."""
    indexes, q = small_indexes
    index = indexes[metric]
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    if kernel:
        def counting(*args):
            counting.launches += 1
            return gather.hop_gather_score_plain(*args)
        counting.launches = 0
        monkeypatch.setattr(gather, "hop_gather_score", counting)
    tracing.enable_device(False)
    tracing.collect()
    d0, r0 = index.search_batch(q, 10, "balanced")
    try:
        tracing.enable_device(True)
        d1, r1 = index.search_batch(q, 10, "balanced")
    finally:
        tracing.enable_device(False)
        got = tracing.collect()
    assert torch.equal(r0, r1) and torch.equal(d0, d1)
    c = got.counters
    max_hops = 200 // 4 + 12
    assert c["hop.bodies_run"] == max_hops
    counted = max_hops if kernel and metric == "euclidean" else 0
    assert c["hop.score_kernel_bodies"] == counted
    if kernel:
        # each search: the first entry's score, one a body where the loop
        # reads rows, and the re-rank where the loop scored a shadow
        per_search = 1 + counted + (metric == "cosine")
        assert gather.hop_gather_score.launches == 2 * per_search

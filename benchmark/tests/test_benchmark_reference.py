"""The plain reference, the check and the control, on the CPU at small sizes.

    python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.cell import Client
from benchmark.control import control_check
from benchmark.datagen import embedding_rows, make_data
from benchmark.spec import load_cell

CPU = torch.device("cpu")


def brute_force(corpus, queries, k, metric):
    """NumPy exact top-k rows and distances (float64)."""
    x = corpus.astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        d = 1 - (q @ x.T) / np.outer(np.linalg.norm(q, axis=1),
                                     np.linalg.norm(x, axis=1))
    else:
        d = np.sqrt(((q[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    rows = np.argsort(d, axis=1, kind="stable")[:, :k]
    return rows, np.take_along_axis(d, rows, 1)


@pytest.fixture(scope="module")
def small():
    x = embedding_rows(900, 96, seed=2**31 + 77, num_clusters=8,
                       topics_seed=3)
    return x[:800], x[800:]


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_reference_top10_is_brute_force(small, metric):
    corpus, queries = small
    want, _ = brute_force(corpus, queries, 10, metric)
    ref = reference.distances(torch.from_numpy(queries).double(),
                              torch.from_numpy(corpus).double(), metric)
    got = torch.topk(ref, 10, dim=1, largest=False).indices.numpy()
    assert np.array_equal(np.sort(got, 1), np.sort(want, 1))


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_judge_passes_exact_answers_and_catches_faults(small, metric):
    corpus, queries = small
    rows, dists = brute_force(corpus, queries, 10, metric)
    qidx = np.arange(len(queries))
    ok = reference.judge(corpus, queries, qidx, rows, dists.astype(
        np.float32), k=10, metric=metric, device=CPU)
    assert ok["invalid_answers"] == 0
    assert ok["recall_at_10"] == 1.0
    assert ok["max_dist_gap"] < 1e-6

    altered = rows.copy()
    altered[3, 0] = (altered[3, 0] + 1) % len(corpus)
    bad = reference.judge(corpus, queries, qidx, altered, dists.astype(
        np.float32), k=10, metric=metric, device=CPU)
    assert bad["max_dist_gap"] > 1e-3 or bad["invalid_answers"] > 0

    missing = rows.copy()
    missing[5, 7] = -1
    bad = reference.judge(corpus, queries, qidx, missing, dists.astype(
        np.float32), k=10, metric=metric, device=CPU)
    assert bad["invalid_answers"] == 1 and bad["invalid"][5]


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12])
    got = reference.tf32_round(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


@pytest.mark.parametrize("cell", ["bible31k.bulk", "fmnist60k.bulk"])
def test_control_fails_the_limit(cell):
    """The control (the reference with TF32 products in the program's place)
    must come out not correct: its widest distance gap is over the
    configuration's limit, while its rows keep the recall bar."""
    spec = load_cell(cell)
    spec["config"] = dict(spec["config"], rows=3000, queries=256)
    spec["traffic"] = dict(spec["traffic"], batch=64)
    got = control_check(spec, 2**31 + 5, 4, CPU)
    limits = spec["config"]["correct"]
    assert got["invalid_answers"] == 0
    assert got["recall_at_10"] >= limits["recall_at_10"]
    assert got["max_dist_gap"] > limits["max_dist_gap"]


def test_rows_come_from_the_seed_and_topics_from_the_configuration():
    """Two seeds draw different rows of the same topics; another topics
    seed moves the topics. The arithmetic is the program's generator's
    (io/datagen.py, "embedding"), whose one generator draws both."""
    def rows(seed, topics_seed):
        return embedding_rows(4000, 768, seed=seed, num_clusters=64,
                              topics_seed=topics_seed)

    a, b, c = rows(2**33 + 1, 42), rows(2**33 + 2, 42), rows(2**33 + 1, 43)
    assert np.array_equal(a, rows(2**33 + 1, 42))
    assert not np.array_equal(a[:10], b[:10])
    assert np.allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)

    def cos(u, v):
        return float(u @ v / np.linalg.norm(u) / np.linalg.norm(v))
    assert cos(a.mean(0), b.mean(0)) > 0.95
    assert cos(a.mean(0), c.mean(0)) < 0.5

    cfg = dict(rows=300, queries=50, dim=768,
               data={"generator": "embedding", "clusters": 64,
                     "topics_seed": 42})
    corpus, pool = make_data(cfg, 2**33 + 1)
    whole = embedding_rows(350, 768, seed=2**33 + 1, num_clusters=64,
                           topics_seed=42)
    assert np.array_equal(np.concatenate([corpus, pool]), whole)


def test_client_wraps_round_the_pool():
    pool = np.arange(10, dtype=np.float32)[:, None]
    c = Client(pool, 4)
    assert c.rows(2).tolist() == [8, 9, 0, 1]
    assert c.queries(2)[:, 0].tolist() == [8, 9, 0, 1]

"""k-means: the coarse quantizer of IVF-HNSW. Counterpart of
``hnsw_tpu/ops/kmeans.py``.

k-means++ init with D^2-weighted sampling and Lloyd's algorithm with a fixed
number of iterations where an emptied cluster keeps its old centroid. The
assignment step is one product + argmin and the centroid update a one-hot
product (a segment sum in a fixed order, so it is deterministic on the
card). The host parts (``sampled_pp_init``, ``balanced_assign``,
``spill_assign``, ``random_partition``) are copies of the reference's numpy
code, so the same seed gives the same picks in both packages.

Precision: the reference's "default" precision is bf16-class on a TPU and
f32 on a CPU; here every product is f32 (TF32 is off), which is what the
reference computes on the CPU the tests run it on.
"""

from __future__ import annotations

import numpy as np
import torch

from hnsw_tpu_torch.ops.distance import BIG, bf16_matmul, distances_from_dots
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric


def _scores(vectors, v_sq, centroids, metric, precision="highest"):
    """Distances [N, K] of every row to every centroid. precision "bf16"
    rounds the operands to bf16 (f32 products); anything else is f32."""
    c_sq = torch.sum(centroids * centroids, dim=-1)
    if precision == "bf16":
        dots = bf16_matmul(vectors, centroids.T)
    else:
        dots = torch.matmul(vectors, centroids.T)
    return distances_from_dots(dots, v_sq[:, None], c_sq[None, :],
                               Metric.coerce(metric))


def kmeans_pp_init(vectors, v_sq, valid, seed: int, *, k: int,
                   metric: Metric):
    """Seeded k-means++ (D^2 sampling) on the device: returns centroids
    [k, D]. The draws come from a torch.Generator, so they differ from the
    reference's jax.random draws for the same seed."""
    n_pad, d = vectors.shape
    dev = vectors.device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    first = torch.multinomial(valid.float(), 1, generator=g)
    cents = torch.zeros((k, d), dtype=torch.float32, device=dev)
    cents[0] = vectors[first[0]]
    min_d = torch.full((n_pad,), BIG, dtype=torch.float32, device=dev)
    for i in range(1, k):
        d_new = _scores(vectors, v_sq, cents[i - 1:i], metric)[:, 0]
        min_d = torch.minimum(min_d, d_new)
        w = torch.where(valid, torch.clamp(min_d, min=0.0) ** 2 + 1e-20, 0.0)
        nxt = torch.multinomial(w, 1, generator=g)
        cents[i] = vectors[nxt[0]]
    return cents


def lloyd(vectors, v_sq, valid, centroids, *, iters: int = 10,
          metric: Metric = Metric.COSINE):
    """Fixed-iteration Lloyd. Returns (centroids [K, D], assign int32
    [N_pad]) with assign = -1 on padding rows. Empty clusters keep their
    previous centroid."""
    k = centroids.shape[0]
    cents = centroids.float()
    validf = valid.float()[:, None]
    for _ in range(iters):
        dist = _scores(vectors, v_sq, cents, metric, precision="default")
        assign = torch.argmin(dist, dim=-1)                 # first minimum
        onehot = torch.nn.functional.one_hot(assign, k).float() * validf
        counts = torch.sum(onehot, dim=0)                   # [K]
        sums = torch.matmul(onehot.T, vectors)              # [K, D]
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0),
                            cents)
    dist = _scores(vectors, v_sq, cents, metric, precision="default")
    assign = torch.where(valid, torch.argmin(dist, dim=-1).to(torch.int32),
                         -1)
    return cents, assign


def _host_metric_dist(x: np.ndarray, c: np.ndarray,
                      metric: Metric) -> np.ndarray:
    """Distances from rows of x [S, D] to one center c [D] on host."""
    dots = x @ c
    if metric == Metric.COSINE:
        denom = np.maximum(np.linalg.norm(x, axis=1) * np.linalg.norm(c),
                           1e-12)
        return (1.0 - dots / denom).astype(np.float32)
    if metric == Metric.EUCLIDEAN:
        return np.maximum((x * x).sum(1) + c @ c - 2 * dots, 0.0)
    return (-dots).astype(np.float32)


def sampled_pp_init(vectors, n: int, *, k: int, seed: int,
                    metric: Metric, sample: int = 4096):
    """Seeded k-means++ (D^2 sampling) over a uniform row sample, on the
    host: one device fetch of the sample instead of k sequential device
    steps. Returns centroids [k, D] on the corpus's device."""
    metric = Metric.coerce(metric)
    s = int(min(max(4 * k, sample), max(n, 1)))
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=s, replace=False)) if s < n \
        else np.arange(n)
    x = vectors[torch.from_numpy(rows.astype(np.int64)).to(vectors.device)] \
        .cpu().numpy().astype(np.float32)
    cents = np.empty((k, x.shape[1]), np.float32)
    cents[0] = x[rng.integers(s)]
    min_d = _host_metric_dist(x, cents[0], metric)
    for i in range(1, k):
        w = np.maximum(min_d, 0.0) ** 2
        tot = w.sum()
        p = w / tot if tot > 0 else np.full(s, 1.0 / s)
        nxt = rng.choice(s, p=p)
        cents[i] = x[nxt]
        min_d = np.minimum(min_d, _host_metric_dist(x, cents[i], metric))
    return torch.from_numpy(cents).to(vectors.device)


def train_kmeans(vectors, v_sq, n: int, *, k: int, seed: int = 42,
                 iters: int = 10, metric: Metric = Metric.COSINE,
                 init: str = "sample_pp"):
    """k-means++ init then Lloyd. init: "sample_pp" (host ++ over a row
    sample, the default) or "device_pp" (the all-device sequential init).
    Returns (centroids [k, D], assign int32 [N_pad])."""
    metric = Metric.coerce(metric)
    n_pad = vectors.shape[0]
    valid = torch.arange(n_pad, device=vectors.device) < n
    if init == "device_pp":
        cents = kmeans_pp_init(vectors, v_sq, valid, seed, k=k, metric=metric)
    else:
        cents = sampled_pp_init(vectors, n, k=k, seed=seed, metric=metric)
    return lloyd(vectors, v_sq, valid, cents, iters=iters, metric=metric)


def _topc_chunk(chunk, chunk_sq, centroids, *, c: int, metric: Metric):
    dist = _scores(chunk, chunk_sq, centroids, metric, precision="default")
    return top_k_ascending(dist, c)


def topc_clusters(vectors, v_sq, n: int, centroids, *,
                  c: int = 4, metric: Metric = Metric.COSINE,
                  chunk: int = 65536):
    """Per-row c nearest centroids (ascending, ties to the lower id),
    row-chunked so the [n, K] distance tile never materializes for large
    corpora. Returns host arrays (dists [n, c], ids [n, c])."""
    k = centroids.shape[0]
    c = min(c, k)
    out_d = np.empty((n, c), np.float32)
    out_i = np.empty((n, c), np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d, i = _topc_chunk(vectors[s:e], v_sq[s:e], centroids, c=c,
                           metric=Metric.coerce(metric))
        out_d[s:e] = d.cpu().numpy()
        out_i[s:e] = i.cpu().numpy()
    return out_d, out_i


def balanced_assign(dist: np.ndarray, cand: np.ndarray, k: int,
                    cap: int, rounds: int = 4) -> np.ndarray:
    """Capacity-constrained assignment from per-row candidate clusters.

    dist/cand: [n, C] ascending candidate distances / cluster ids (from
    topc_clusters). Round-based spill: every round, clusters over `cap`
    keep their cap highest-eviction-cost rows (cost = distance increase of
    moving to the row's next candidate) and evict the rest to that next
    candidate. Leftovers after `rounds` go to the least-loaded cluster."""
    n, c_width = cand.shape
    assign = cand[:, 0].astype(np.int64).copy()
    choice = np.zeros(n, np.int64)
    nxt = np.minimum(choice + 1, c_width - 1)
    for _ in range(rounds):
        counts = np.bincount(assign, minlength=k)
        if (counts <= cap).all():
            break
        cost = dist[np.arange(n), nxt] - dist[np.arange(n), choice]
        # exhausted candidate lists never evict (cost inf)
        cost = np.where(choice >= c_width - 1, np.inf, cost)
        # rank rows within their cluster by cost DESC (keep costly-to-move)
        order = np.lexsort((-cost, assign))
        a_sorted = assign[order]
        first = np.searchsorted(a_sorted, a_sorted, side="left")
        pos = np.arange(n) - first
        evict = np.zeros(n, bool)
        evict[order[pos >= cap]] = True
        evict &= np.isfinite(cost)
        choice = np.where(evict, nxt, choice)
        assign = cand[np.arange(n), choice].astype(np.int64)
        nxt = np.minimum(choice + 1, c_width - 1)
    # force-fix any residual overflow: move excess rows to least-loaded
    counts = np.bincount(assign, minlength=k)
    if (counts > cap).any():
        order = np.lexsort((dist[np.arange(n), choice], assign))
        a_sorted = assign[order]
        first = np.searchsorted(a_sorted, a_sorted, side="left")
        pos = np.arange(n) - first
        excess_rows = order[pos >= cap]
        for r in excess_rows:
            tgt = int(np.argmin(counts))
            counts[assign[r]] -= 1
            assign[r] = tgt
            counts[tgt] += 1
    return assign.astype(np.int32)


def spill_assign(primary: np.ndarray, dist: np.ndarray, cand: np.ndarray,
                 k: int, cap: int) -> np.ndarray:
    """Secondary cluster per row (SOAR-style multi-assignment): the nearest
    candidate different from the primary, capped per cluster (overflow rows
    get -1 = no spill)."""
    n, c_width = cand.shape
    is_primary = cand == primary[:, None]
    # first candidate != primary
    sec_choice = np.argmax(~is_primary, axis=1)
    has = ~is_primary[np.arange(n), sec_choice]
    secondary = np.where(has, cand[np.arange(n), sec_choice], -1).astype(np.int64)
    sec_dist = np.where(has, dist[np.arange(n), sec_choice], np.inf)
    # cap per cluster: keep closest rows
    ok = secondary >= 0
    order = np.lexsort((sec_dist, secondary))
    s_sorted = secondary[order]
    first = np.searchsorted(s_sorted, s_sorted, side="left")
    pos = np.arange(n) - first
    drop = np.zeros(n, bool)
    drop[order] = pos >= cap
    secondary[drop | ~ok] = -1
    return secondary.astype(np.int32)


def random_partition(n: int, k: int, seed: int = 42,
                     shuffle: bool = True) -> np.ndarray:
    """Random equal split, shuffled first (critical for ordered corpora).
    Returns assign [n] int32."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    assign = np.empty(n, np.int32)
    # contiguous equal chunks over the shuffled order
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    for c in range(k):
        assign[order[bounds[c]:bounds[c + 1]]] = c
    return assign

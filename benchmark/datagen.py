"""The benchmark's rows and queries, made from ``--seed``.

The arithmetic of the "embedding" branch of
``hnsw_tpu_torch/io/datagen.py:generate_vectors``, frozen here so that a
later change to the program's generator cannot change what the benchmark
measures: unit topic centres on an r-dim latent manifold, Zipf-sized
topics, a point = a * centre + sqrt(1 - a^2) * residual, a random
up-projection, a little off-manifold noise, then unit norm.

One departure: the topics (the centres and the projection) are part of the
configuration, drawn from its ``topics_seed``, and only the rows (their
topics, residuals and noise) from ``--seed``. Every seed then draws fresh
rows of one distribution, as a deployment's corpus is, instead of a new
geometry whose isolated small topics move recall by a percent from seed to
seed. The corpus and the held-out queries are one draw, so both follow the
same topics.
"""

from __future__ import annotations

import numpy as np


def embedding_rows(n: int, dim: int, *, seed: int, num_clusters: int,
                   topics_seed: int, center_weight: float = 0.72
                   ) -> np.ndarray:
    """[n, dim] float32 rows of unit norm."""
    topics = np.random.default_rng(topics_seed)
    rng = np.random.default_rng(seed)
    r = max(min(dim, 32), dim // 8)
    centers = topics.standard_normal((num_clusters, r)).astype(np.float32)
    centers /= np.maximum(np.linalg.norm(centers, axis=1, keepdims=True),
                          1e-12)
    proj = (topics.standard_normal((r, dim)).astype(np.float32)
            / np.sqrt(r, dtype=np.float32))
    p = (np.arange(1, num_clusters + 1, dtype=np.float64)) ** -0.7
    p /= p.sum()
    assign = rng.choice(num_clusters, size=n, p=p)
    resid = rng.standard_normal((n, r)).astype(np.float32)
    resid /= np.maximum(np.linalg.norm(resid, axis=1, keepdims=True), 1e-12)
    a = float(center_weight)
    z = a * centers[assign] + np.sqrt(max(1.0 - a * a, 0.0)) * resid
    x = z @ proj
    x += 0.02 * rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x


def make_data(config: dict, seed: int):
    """(corpus [rows, dim], queries [queries, dim]) float32 for a
    configuration: one draw of rows + queries, split."""
    data = config["data"]
    if data["generator"] != "embedding":
        raise ValueError(f"unknown generator {data['generator']!r}")
    n, nq = config["rows"], config["queries"]
    x = embedding_rows(n + nq, config["dim"], seed=seed,
                       num_clusters=data["clusters"],
                       topics_seed=data["topics_seed"])
    return x[:n], x[n:]

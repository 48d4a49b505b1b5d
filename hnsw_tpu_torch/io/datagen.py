"""Seeded synthetic data generation — the de-facto fixture system.

Mirrors the reference's test/data_generator.clj: named dimension presets
matching real embedding models (:9-16), size presets tiny..stress (:19-26),
gaussian/uniform/unit/clustered distributions from a seeded RNG (:50-87),
dataset save/load as JSON with metadata (:122-167), and ground-truth helpers
(:181-203).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# data_generator.clj:9-16 — dims of popular embedding models
DIMENSION_PRESETS: Dict[str, int] = {
    "minilm": 256,
    "small": 384,
    "mpnet": 768,
    "bert-large": 1024,
    "openai-ada": 1536,
    "large": 2048,
    "openai-3-large": 3072,
}

# data_generator.clj:19-26
SIZE_PRESETS: Dict[str, int] = {
    "tiny": 100,
    "small": 1000,
    "medium": 5000,
    "large": 10000,
    "xlarge": 20000,
    "bible": 30000,
    "stress": 50000,
}


def generate_vectors(
    n,
    dim,
    *,
    distribution: str = "gaussian",
    seed: int = 42,
    num_clusters: int = 10,
    noise: float = 0.1,
    fmt: str = "array",          # "array" | "indexed" (["vec_i", arr] pairs)
    latent_dim: Optional[int] = None,   # "embedding" only
    center_weight: float = 0.72,        # "embedding" only
):
    """Seeded synthetic vectors (data_generator.clj:50-87)."""
    n = SIZE_PRESETS.get(n, n) if isinstance(n, str) else int(n)
    dim = DIMENSION_PRESETS.get(dim, dim) if isinstance(dim, str) else int(dim)
    rng = np.random.default_rng(seed)
    if distribution == "embedding":
        # Realistic text-embedding geometry (the reference's corpus is mpnet
        # Bible verses: normalized, strongly clustered by book/topic —
        # export_complete_bible.py:91). Real embeddings concentrate near a
        # low-dimensional manifold (effective dim ~30-100 at D=768) with
        # within-topic cosine ~0.5-0.8 and cross-topic ~0.1. Naive
        # "centers + full-dim gaussian noise" misses this badly: at D=768
        # the noise norm is ~sqrt(D)x the center norm, so the result is
        # near-uniform on the sphere. Here: unit topic centers in an
        # r-dim latent space, point = a*center + sqrt(1-a^2)*residual,
        # Zipf-skewed topic sizes, random up-projection, tiny off-manifold
        # fuzz, then normalize.
        r = latent_dim or max(min(dim, 32), dim // 8)
        centers = rng.standard_normal((num_clusters, r)).astype(np.float32)
        centers /= np.maximum(np.linalg.norm(centers, axis=1, keepdims=True),
                              1e-12)
        p = (np.arange(1, num_clusters + 1, dtype=np.float64)) ** -0.7
        p /= p.sum()
        assign = rng.choice(num_clusters, size=n, p=p)
        resid = rng.standard_normal((n, r)).astype(np.float32)
        resid /= np.maximum(np.linalg.norm(resid, axis=1, keepdims=True),
                            1e-12)
        a = float(center_weight)
        z = a * centers[assign] + np.sqrt(max(1.0 - a * a, 0.0)) * resid
        proj = (rng.standard_normal((r, dim)).astype(np.float32)
                / np.sqrt(r, dtype=np.float32))
        x = z @ proj
        x += 0.02 * rng.standard_normal((n, dim)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    elif distribution == "gaussian":
        x = rng.standard_normal((n, dim)).astype(np.float32)
    elif distribution == "uniform":
        x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    elif distribution == "unit":
        x = rng.standard_normal((n, dim)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    elif distribution == "clustered":
        centers = rng.standard_normal((num_clusters, dim)).astype(np.float32)
        assign = rng.integers(0, num_clusters, n)
        x = (centers[assign]
             + noise * rng.standard_normal((n, dim)).astype(np.float32))
    else:
        raise ValueError(f"unknown distribution {distribution}")
    if fmt == "indexed":
        return [[f"vec_{i}", x[i]] for i in range(n)]
    return x


def save_dataset(path: str, vectors: np.ndarray, *, metadata: Optional[dict] = None):
    """JSON dataset with metadata (data_generator.clj:122-140)."""
    payload = {
        "metadata": dict(metadata or {},
                         count=int(vectors.shape[0]),
                         dimensions=int(vectors.shape[1])),
        "vectors": [{"id": f"vec_{i}", "embedding": vectors[i].tolist()}
                    for i in range(vectors.shape[0])],
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def load_dataset(path: str) -> Tuple[np.ndarray, List[str], dict]:
    with open(path) as f:
        payload = json.load(f)
    vecs = np.asarray([v["embedding"] for v in payload["vectors"]], np.float32)
    ids = [v["id"] for v in payload["vectors"]]
    return vecs, ids, payload.get("metadata", {})


def generate_test_matrix(sizes=("tiny", "small"), dims=("minilm", "mpnet"),
                         seed: int = 42):
    """Materialize a size x dim grid (data_generator.clj:146-167)."""
    out = {}
    for s in sizes:
        for d in dims:
            out[(s, d)] = generate_vectors(s, d, seed=seed)
    return out


# ---- ground-truth helpers (data_generator.clj:181-203) -----------------

def vector_distance(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).sum()))


def cosine_similarity(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / max(na * nb, 1e-12))


def add_noise(x, scale: float = 0.01, seed: int = 42):
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    return x + scale * rng.standard_normal(x.shape).astype(np.float32)

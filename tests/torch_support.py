"""Shared helper of the hnsw_tpu_torch tests that compare with the JAX
package."""

import numpy as np


def recall(rows, exact_rows) -> float:
    """Mean |rows ∩ exact| / k per query (rows -1 never count)."""
    rows = np.asarray(rows)
    exact_rows = np.asarray(exact_rows)
    hits = [len(set(a[a >= 0].tolist()) & set(e.tolist()))
            for a, e in zip(rows, exact_rows)]
    return float(np.mean(hits)) / exact_rows.shape[1]

"""The plain reference and the check that decides ``correct``.

Plain PyTorch, independent of the program: it imports nothing of
``hnsw_tpu_torch`` and takes nothing the program made. From the corpus rows
and the query pool that the benchmark drew, it works out in float64 the
distance of every query to every row, the exact top-k, and from those judges
every answer the timed path returned:

- ``invalid_answers``: answers (one query's k rows) with a row outside the
  corpus, a row twice, a distance that is not finite, or distances out of
  ascending order. Exact: limit 0.
- ``max_dist_gap``: the widest gap between a returned distance and the
  reference's distance of the same query and row. Cosine (1 - cos, terms of
  size 1): the gap itself. Euclidean (the program returns the L2 distance):
  the gap of the squares over |q|^2 + |x|^2, the size of the terms whose
  difference the distance is. The program re-ranks its final rows in f32, so
  this reads f32 rounding; a lower precision reads far more.
- ``recall_at_10``: mean |returned rows & exact top-k| / k over every answer,
  against the bar the configuration states.

``control_answers`` is the control: this reference put in the program's
place with its products in TF32, the precision next below the f32 that the
configuration states (inputs rounded to 10 mantissa bits, sums in f32). Its
rows are near exact, its distances are not, and the check must fail it.
"""

from __future__ import annotations

import numpy as np
import torch

# pool queries scored against the whole corpus at once
QUERY_BLOCK = 1024


def _exact_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def distances(q: torch.Tensor, x: torch.Tensor, metric: str):
    """[Q, N] distances of q [Q, D] to x [N, D], in q's dtype. Cosine:
    1 - cos; euclidean: the squared L2 distance."""
    dots = q @ x.T
    qq = (q * q).sum(1, keepdim=True)
    xx = (x * x).sum(1)[None, :]
    if metric == "cosine":
        return 1.0 - dots / torch.sqrt(torch.clamp(qq * xx, min=1e-300))
    if metric == "euclidean":
        return torch.clamp(qq + xx - 2.0 * dots, min=0.0)
    raise ValueError(f"unknown metric {metric!r}")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest even, as the
    tensor cores read TF32 operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def control_answers(corpus: np.ndarray, queries: np.ndarray, k: int,
                    metric: str, device) -> tuple:
    """The control's (rows [Q, k] int64, distances [Q, k] float32): exact
    top-k of TF32 products, distances in the program's form (cosine 1 - cos,
    euclidean the L2 distance)."""
    _exact_off()
    x = tf32_round(torch.from_numpy(corpus).to(device))
    rows, dist = [], []
    for s in range(0, len(queries), QUERY_BLOCK):
        q = tf32_round(torch.from_numpy(queries[s:s + QUERY_BLOCK])
                       .to(device))
        d, r = torch.topk(distances(q, x, metric), k, dim=1, largest=False)
        if metric == "euclidean":
            d = torch.sqrt(d)
        rows.append(r.cpu().numpy())
        dist.append(d.cpu().numpy())
    return np.concatenate(rows), np.concatenate(dist)


def _invalid(rows: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    """[A] bool: answers that break a guarantee on their own."""
    bad = ((rows < 0) | (rows >= n)).any(1)
    srt = np.sort(rows, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= ~np.isfinite(dists).all(1)
    bad |= (np.diff(dists, axis=1) < 0).any(1)
    return bad


def judge(corpus: np.ndarray, queries: np.ndarray, qidx: np.ndarray,
          rows: np.ndarray, dists: np.ndarray, *, k: int, metric: str,
          device) -> dict:
    """Judge answers: qidx [A] (the pool row of each answer's query), rows
    [A, k], dists [A, k]. Returns invalid_answers, the [A] bool of them
    (`invalid`), max_dist_gap and recall_at_10."""
    _exact_off()
    n = corpus.shape[0]
    invalid = _invalid(rows, dists, n)
    x = torch.from_numpy(corpus).to(device).double()
    order = np.argsort(qidx, kind="stable")
    sq = qidx[order]
    gap = 0.0
    hits = 0
    for s in range(0, len(queries), QUERY_BLOCK):
        lo, hi = np.searchsorted(sq, [s, s + QUERY_BLOCK])
        if lo == hi:
            continue
        q = torch.from_numpy(queries[s:s + QUERY_BLOCK]).to(device).double()
        ref = distances(q, x, metric)                         # [QB, N]
        top = torch.topk(ref, k, dim=1, largest=False).indices
        sel = order[lo:hi]
        local = torch.from_numpy(sq[lo:hi] - s).to(device)
        r = torch.from_numpy(rows[sel].astype(np.int64)).to(device)
        rc = r.clamp(0, n - 1)
        d = torch.from_numpy(dists[sel]).to(device).double()
        want = ref[local[:, None], rc]
        if metric == "euclidean":
            scale = (q * q).sum(1)[local][:, None] + (x * x).sum(1)[rc]
            g = (d * d - want).abs() / scale
        else:
            g = (d - want).abs()
        gap = max(gap, float(torch.nan_to_num(g, nan=np.inf).max()))
        hits += int((r[:, :, None] == top[local][:, None, :]).any(2).sum())
    return dict(invalid_answers=int(invalid.sum()), invalid=invalid,
                max_dist_gap=gap,
                recall_at_10=hits / (len(qidx) * k) if len(qidx) else 0.0)

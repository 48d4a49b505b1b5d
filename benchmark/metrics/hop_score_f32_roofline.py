"""hop_score_f32_roofline: the gather-score kernel G1's share of its byte
bound, in %.

G1 (``ops/gather.py:hop_gather_score``, ``csrc/gather.cu``) scores rows
that it gathers from the corpus: every hop body of a loop with no neighbour
pack, the seeds, the first entry and the f32 re-rank. The bound of a call is
the least its operands need (``g1_bytes``): each distinct valid row, with its
f32 norm, once, and the queries, their norms, the ids, the flags and the
f32 output once each, over the card's HBM bandwidth. Rows that several
queries of the batch reach are counted once, so no kernel that reads each
byte it needs reads above 100%. The share is the bounds' sum over the
kernels' summed device time, over the first ``BATCHES`` batches of the
traced window. As in ``hop_score_roofline.py``, no launch's operands are
visible in the replayed window: after it, the same batches run once more
through the index's eager search, with ``hop_gather_score`` wrapped to count
each call's bytes. None where the window launched no G1, or where the
wrapped calls and the window's launches disagree in number.
"""

import torch

from benchmark.peaks import HBM_BYTES_S

KERNEL = "gather_score_kernel"
BATCHES = 16


def g1_bytes(queries, rows, vectors, valid) -> int:
    """Bytes one G1 call must move: each distinct valid row (its values and
    its f32 norm) once, the f32 queries [B, D] and their norms, the ids and
    bool flags [B, C], and the f32 output [B, C]."""
    b, c = rows.shape
    d = vectors.shape[1]
    uniq = int(torch.unique(rows[valid]).numel())
    return (uniq * (d * vectors.element_size() + 4) + b * d * 4 + b * 4
            + b * c * (rows.element_size() + 1) + b * c * 4)


def _bytes_per_batch(ctx, batches):
    import hnsw_tpu_torch.ops.gather as gather

    real = gather.hop_gather_score
    counted = []

    def counting(queries, rows, vectors, v_sq, metric, valid, q_sq=None):
        counted[-1].append(g1_bytes(queries, rows, vectors, valid))
        return real(queries, rows, vectors, v_sq, metric, valid, q_sq)

    counting.launches = 0     # the kernel's wrapper counts into its global
    run, _ = ctx.index._search_fn(ctx.k, ctx.mode, ctx.ef, False)
    gather.hop_gather_score = counting
    try:
        for i in range(batches):
            counted.append([])
            run(ctx.index.corpus.pad_queries(
                ctx.client.queries(ctx.first_traced + i)))
    finally:
        gather.hop_gather_score = real
    return counted


def read(ctx):
    if not ctx.window:
        return None
    launches = [e for e in ctx.window.kernels() if KERNEL in e.name]
    if not launches:
        return None
    counted = _bytes_per_batch(ctx, min(BATCHES, ctx.traced))
    per = len(counted[0])
    # every traced request replays the graph captured from this search, so
    # the window holds `per` launches for each of them
    if per == 0 or any(len(c) != per for c in counted) or \
            len(launches) != per * ctx.traced:
        return None
    seconds = sum(e.end - e.start for e in launches[:per * len(counted)])
    return 100.0 * sum(map(sum, counted)) / HBM_BYTES_S / seconds

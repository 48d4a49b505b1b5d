"""hop_score_int8_roofline: the int8 hop kernel B2's share of its byte bound,
in %.

The bound of a launch is the bytes its operands need (``peaks.hop_bytes``
with the int8 codes' element size of 1: each distinct selected neighbour
block of codes once, the f32 queries, the rows and one f32 output) over the
card's HBM bandwidth; the share is the bounds' sum over the kernels' summed
device time, over the first ``BATCHES`` batches of the traced window. As in
``hop_score_roofline.py``, no launch's operands are visible in the replayed
window: after it, the same batches run once more through the index's eager
search, with ``ops.hop.hop_score_int8`` wrapped to count each launch's
bytes. None where the window launched no B2.
"""

from benchmark.peaks import HBM_BYTES_S, hop_bytes

KERNEL = "hop_int8_kernel"
BATCHES = 16


def _bytes_per_batch(ctx, batches):
    import hnsw_tpu_torch.ops.hop as hop

    real = hop.hop_score_int8
    counted = []

    def counting(pack, queries, sel_rows):
        counted[-1].append(hop_bytes(pack, queries, sel_rows, outs=1))
        return real(pack, queries, sel_rows)

    counting.launches = 0     # the kernel's wrapper counts into its global
    run, _ = ctx.index._search_fn(ctx.k, ctx.mode, ctx.ef, False)
    hop.hop_score_int8 = counting
    try:
        for i in range(batches):
            counted.append([])
            run(ctx.index.corpus.pad_queries(
                ctx.client.queries(ctx.first_traced + i)))
    finally:
        hop.hop_score_int8 = real
    return counted


def read(ctx):
    if not ctx.window:
        return None
    launches = [e for e in ctx.window.kernels() if KERNEL in e.name]
    if not launches:
        return None
    counted = _bytes_per_batch(ctx, min(BATCHES, ctx.traced))
    per = len(counted[0])
    if per == 0 or any(len(c) != per for c in counted) or \
            len(launches) < per * len(counted):
        return None
    seconds = sum(e.end - e.start for e in launches[:per * len(counted)])
    return 100.0 * sum(map(sum, counted)) / HBM_BYTES_S / seconds

"""search.phase.rerank_ms: device milliseconds a batch of the search's `rerank`
phase: the exact f32 re-rank after the loop. Read from the program's device
marks (the card's clock inside the captured graph) over the traced batches of
benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("rerank") if pt else None

"""search.phase.score_ms: device milliseconds a batch of the search's `score`
phase: each body's scoring (B1 hop_score on a bf16 pack, or the f32 row gather
and product) and its masking. Read from the program's device marks (the card's
clock inside the captured graph) over the traced batches of
benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("score") if pt else None

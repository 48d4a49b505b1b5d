"""search.phase.expand_ms: device milliseconds a batch of the search's `expand`
phase: each body's adjacency gather, dedupe and in-beam test. Read from the
program's device marks (the card's clock inside the captured graph) over the
traced batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("expand") if pt else None

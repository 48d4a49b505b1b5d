"""search.phase.select_ms: device milliseconds a batch of the search's `select`
phase: each body's eligibility, cumsum, stop rule and one-hot pick of the rows
to expand. Read from the program's device marks (the card's clock inside the
captured graph) over the traced batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("select") if pt else None

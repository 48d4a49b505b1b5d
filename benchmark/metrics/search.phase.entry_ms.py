"""search.phase.entry_ms: device milliseconds a batch of the search's `entry`
phase: the entry (sample_entries or the D1 descent) and the beam's seed. Read
from the program's device marks (the card's clock inside the captured graph)
over the traced batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("entry") if pt else None

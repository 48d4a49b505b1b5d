"""search.event_ms_per_batch: device milliseconds a batch of the search, from
the program's device marks: the sum of its six phases (entry, select, expand,
score, merge, rerank), without the counters' own `count` phase, over the traced
batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt:
        return None
    parts = [pt.per_batch_ms(p) for p in program_trace.SIX]
    return None if None in parts else sum(parts)

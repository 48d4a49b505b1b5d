"""entry.pad_ms: mean host milliseconds of the program's hnsw.search.pad span,
the padding of the queries and their copy to the card, over the window's
requests that ran before the profiler started (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    s = pt.mean("requests", "pad") if pt else None
    return None if s is None else s * 1e3

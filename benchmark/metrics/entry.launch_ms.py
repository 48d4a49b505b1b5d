"""entry.launch_ms: mean host milliseconds of the program's hnsw.search.replay
span, the replay of the captured search: the static copy, the graph's launch
and the launch counts, over the window's requests that ran before the profiler
started (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    s = pt.mean("requests", "replay") if pt else None
    return None if s is None else s * 1e3

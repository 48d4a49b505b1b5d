"""build.fetch_s: mean seconds of the program's hnsw.build.fetch span, waiting
for the device layers' adjacency, over the set-up's timed builds of the whole
corpus (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.mean("builds", "fetch") if pt else None

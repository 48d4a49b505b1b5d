"""build.layers_s: mean seconds of the program's hnsw.build.layers span, layer
0's dispatch and the upper layers built on the host, over the set-up's timed
builds of the whole corpus (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.mean("builds", "layers") if pt else None

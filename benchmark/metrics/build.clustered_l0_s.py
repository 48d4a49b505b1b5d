"""build.clustered_l0_s: mean seconds of the program's hnsw.build.clustered_l0
span, layer 0 built by the clustered builder (models/hnsw/build_large.py,
which returns its adjacency on the host, so the span holds its device work),
over the set-up's timed builds of the whole corpus
(benchmark/program_trace.py). None where no timed build has the span."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.mean("builds", "clustered_l0") if pt else None

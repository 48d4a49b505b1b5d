"""build.large.symmetrize_s: mean seconds of the program's
hnsw.build.large.symmetrize span, the first reverse-edge collection and
re-prune, in the layer that the clustered builder
(models/hnsw/build_large.py) builds, closed after a wait for its device
work, over the set-up's timed builds of the whole corpus
(benchmark/program_trace.py). None where no timed build ran that builder.
"""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.mean("builds", "symmetrize") if pt else None

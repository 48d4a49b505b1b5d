"""build.repair_s: mean seconds of the program's hnsw.build.repair span, the
connectivity repair (bridge_components), over the set-up's timed builds of the
whole corpus (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.mean("builds", "repair") if pt else None

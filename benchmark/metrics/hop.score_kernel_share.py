"""hop.score_kernel_share: the hop bodies whose score (the gather and dot of
the candidates' rows, where the loop reads rows and not a neighbour pack)
launched the program's hand-written gather-score kernel, over the bodies
run. From the program's counters over the traced batches of
benchmark/program_trace.py; None for a program without that counter."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt or "hop.score_kernel_bodies" not in pt.counters:
        return None
    base = pt.counters["hop.bodies_run"]
    return pt.counters["hop.score_kernel_bodies"] / base if base else None

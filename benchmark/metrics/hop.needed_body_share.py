"""hop.needed_body_share: the hop bodies in which some query was still active
over the bodies run (the card runs max_hops for every batch). From the
program's counters over the traced batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt or "hop.bodies_needed" not in pt.counters:
        return None
    base = pt.counters["hop.bodies_run"]
    return pt.counters["hop.bodies_needed"] / base if base else None

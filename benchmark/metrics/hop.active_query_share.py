"""hop.active_query_share: the queries still active after a body's stop rule,
summed over the bodies, over the batch's queries times the bodies run. From the
program's counters over the traced batches of benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt or "hop.query_bodies_active" not in pt.counters:
        return None
    base = pt.counters["hop.bodies_run"] * pt.batch
    return pt.counters["hop.query_bodies_active"] / base if base else None

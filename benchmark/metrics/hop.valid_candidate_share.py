"""hop.valid_candidate_share: the slots a body scores (B x E x M0) that hold a
row that is selected, not a duplicate and not yet in the beam, over all it
scores. From the program's counters over the traced batches of
benchmark/program_trace.py."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt or "hop.slots_valid" not in pt.counters:
        return None
    base = pt.counters["hop.slots_scored"]
    return pt.counters["hop.slots_valid"] / base if base else None

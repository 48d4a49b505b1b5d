"""hop.merge_kernel_share: the hop bodies whose beam update (the stable
merge of the scored candidates and the next body's select) launched the
program's hand-written merge kernel, over the bodies run. From the program's
counters over the traced batches of benchmark/program_trace.py; None for a
program without that counter."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt or "hop.merge_kernel_bodies" not in pt.counters:
        return None
    base = pt.counters["hop.bodies_run"]
    return pt.counters["hop.merge_kernel_bodies"] / base if base else None

"""search.phase.dequant_ms: device milliseconds a batch of the search's
`dequant` phase, on the int8 neighbour pack's route: from the return of each
body's hop_score_int8 (B2), the scale and norm gathers, the product with the
scale, the distance and the mask. Read from the program's device marks (the
card's clock inside the captured graph) over the traced batches of
benchmark/program_trace.py. None where the program marks no such phase."""

from benchmark import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return pt.per_batch_ms("dequant") if pt else None

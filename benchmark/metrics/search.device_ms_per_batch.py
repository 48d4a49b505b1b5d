"""search.device_ms_per_batch: the kernels' device milliseconds in the traced
window over the batches it holds (copies left out)."""


def read(ctx):
    if not ctx.window or not ctx.traced:
        return None
    kernels = ctx.window.kernels()
    if not kernels:
        return None
    return sum(e.end - e.start for e in kernels) * 1e3 / ctx.traced

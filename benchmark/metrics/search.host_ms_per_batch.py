"""search.host_ms_per_batch: the mean host milliseconds from the call of
HNSWIndex.search_batch to its return, before the answers are waited for,
over the requests of the window that ran before the profiler started (the
benchmark's own span; the profiler slows the replay's launch)."""


def read(ctx):
    untraced = ctx.requests[:ctx.first_traced]
    if not untraced:
        return None
    return sum(r.t_ret - r.t0 for r in untraced) * 1e3 / len(untraced)

"""build.clustered_upper_s: seconds of the upper layers that the clustered
builder (models/hnsw/build_large.py) builds: per timed build of the whole
corpus, the sum of its hnsw.build.clustered_l<l> spans for l >= 1, then the
mean over the builds that have one (benchmark/program_trace.py). None where
no timed build has such a span."""

from benchmark import program_trace

PREFIX = "clustered_l"


def _upper(build):
    """Seconds of each clustered layer above layer 0 in one build."""
    return [s for name, s in build.items() if name.startswith(PREFIX)
            and name[len(PREFIX):].isdigit() and int(name[len(PREFIX):]) >= 1]


def read(ctx):
    pt = program_trace.get(ctx)
    if not pt:
        return None
    sums = [sum(u) for u in map(_upper, pt.builds) if u]
    return sum(sums) / len(sums) if sums else None

"""What the port's tracer costs on the card, for cells of BENCHMARK.json.

For each cell, builds the cell's index from `--seed` with the benchmark's
own data and family, then times its batch size on the card, in turns
untraced, traced, traced, untraced: `--reps` back-to-back calls of
HNSWIndex.search_batch between two CUDA events, so the device ms a batch of
the captured search without device tracing (the graph the benchmark
measures) and with it (its marks and counters). Prints each cell's traced
phases and counters, and once, the host microseconds of one span on this
host and what the profiler makes of the mirrored spans (device events named
hnsw.*, and how many of them benchmark/trace.py keeps as operations: none
should be). One JSON line each.

    python3 scripts/trace_cost.py [--cells bible31k.bulk,bible31k.online]
                                  [--seed 7] [--reps 10] [--rounds 2]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark.datagen import make_data  # noqa: E402
from benchmark.spec import load_cell, load_family  # noqa: E402
from hnsw_tpu_torch.utils import tracing  # noqa: E402

def say(**kw):
    print(json.dumps(kw), flush=True)


def batch_ms(search, q, reps: int) -> float:
    """Device ms a batch: `reps` calls back to back between two events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        search(q)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cell_cost(name: str, seed: int, reps: int, rounds: int):
    spec = load_cell(name)
    cfg, mix = spec["config"], spec["traffic"]
    family = load_family(cfg["index"]["family"])
    corpus, pool = make_data(cfg, seed)
    dev = torch.device("cuda")
    family.build(corpus[:2048], cfg, dev)
    index = family.build(corpus, cfg, dev)
    q = index.corpus.pad_queries(pool[:mix["batch"]])

    def search(x):
        return family.search(index, x, cfg)

    times = {False: [], True: []}
    for on in (False, True):                 # captures, each warmed
        tracing.enable_device(on)
        search(q)
        search(q)
    tracing.enable_device(False)
    tracing.collect()
    for _ in range(rounds):
        for on in (False, True, True, False):
            tracing.enable_device(on)
            times[on].append(batch_ms(search, q, reps))
    tracing.enable_device(False)
    got = tracing.collect()
    off, on = statistics.median(times[False]), statistics.median(times[True])
    runs = max(got.runs, 1)
    phases = {p: ms / runs for p, ms in got.phase_ms.items()}
    six = sum(v for p, v in phases.items() if p != "count")
    c = got.counters
    say(cell=name, card=torch.cuda.get_device_name(0), batch=mix["batch"],
        untraced_ms=times[False], traced_ms=times[True],
        untraced_median_ms=off, traced_median_ms=on,
        on_cost=(on - off) / off, runs=got.runs, phase_ms=phases,
        six_phases_ms=six, all_phases_ms=six + phases["count"],
        needed_body_share=c["hop.bodies_needed"] / c["hop.bodies_run"],
        active_query_share=c["hop.query_bodies_active"]
        / (c["hop.bodies_run"] * mix["batch"]),
        valid_candidate_share=c["hop.slots_valid"] / c["hop.slots_scored"])
    # the host spans of requests as the benchmark sends them (host rows
    # in, answers waited for), device tracing off
    rows = pool[:mix["batch"]]
    for _ in range(20):
        d, r = search(rows)
        d.cpu(), r.cpu()
    spans = tracing.collect().spans
    roots = {s.id for s in spans if s.name == "hnsw.search"}
    host = {}
    for s in spans:
        if s.request in roots:
            host.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    say(cell=name, host_ms={k: statistics.mean(v) for k, v in host.items()},
        requests=len(roots))
    return index, search, q


def span_cost(n: int = 200_000):
    """Host ns of one span, and of the five a request records."""
    best = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("hnsw.search.pad"):
                pass
        best.append((time.perf_counter_ns() - t0) / n)
    tracing.collect()
    say(span_ns=best, request_spans=5, request_us=5 * min(best) / 1e3)


def mirror_check(search, q):
    """The mirrored spans under a CPU + CUDA profiler: their device
    events, and what benchmark/trace.py keeps of them."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            search(q)
        torch.cuda.synchronize()
    spans = [s for s in tracing.collect().spans
             if s.name == "hnsw.search"]
    from torch.autograd import DeviceType
    named = [e for e in prof.profiler.kineto_results.events()
             if e.name().startswith("hnsw.")]
    on_card = [e for e in named if e.device_type() != DeviceType.CPU]
    host = [e for e in named if e.device_type() == DeviceType.CPU
            and e.name() == "hnsw.search"]
    device, _ = trace.split_events(prof)
    kept = [e for e in device if e.name.startswith("hnsw.")]
    gaps = [(s.start_ns - e.start_ns(),
             s.end_ns - e.start_ns() - e.duration_ns())
            for s, e in zip(spans, host)]
    say(mirrored_on_card=len(on_card),
        annotations=sum(bool(e.is_user_annotation()) for e in on_card),
        kept_as_operations=len(kept), host_events=len(host),
        span_minus_event_ns=gaps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells",
                    default="bible31k.bulk,bible31k.online,fmnist60k.bulk")
    ap.add_argument("--seed", type=int, default=2**31 + 1717)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA card", file=sys.stderr)
        return 2
    span_cost()
    last = None
    for name in args.cells.split(","):
        last = cell_cost(name, args.seed, args.reps, args.rounds)
    if last is not None:
        mirror_check(*last[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())

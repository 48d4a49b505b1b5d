#!/usr/bin/env python3
"""What the clustered builder's stage waits cost, on one CUDA card, at a
benchmark cell's corpus.

    python3 scripts/large_stage_cost.py [--workload nytimes290k.bulk]
        [--seed 7] [--pairs 3]

Makes the cell's rows from --seed (benchmark/datagen.py), builds its index
as the benchmark does (benchmark/families/<family>.py: build_hnsw_index)
once to warm the process, then --pairs pairs of builds in turns (waits on,
off, off, on, ...): "off" replaces build_large._wait, the synchronize that
closes each hnsw.build.large.* stage span, by nothing. Prints one JSON line
per build: its seconds on the host clock (to a synchronize), the seconds of
its spans (hnsw.build, .layers, .fetch, .repair, .large and its four stages:
with the waits off the stages time the host's enqueue only), and its peak
device memory; then the median of each side. First it prints the card's
name and power limit, the rows of each level as build_graph draws them,
LARGE_N, and the builder's plan line (logged at INFO). Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="nytimes290k.bulk")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("large_stage_cost: no CUDA device", file=sys.stderr)
        return 1
    from benchmark.datagen import make_data
    from benchmark.spec import load_cell, load_family
    from hnsw_tpu_torch.models.hnsw import build_large
    from hnsw_tpu_torch.models.hnsw.graph import assign_levels
    from hnsw_tpu_torch.utils import tracing

    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
    logging.getLogger(build_large.__name__).setLevel(logging.INFO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    cfg = load_cell(args.workload)["config"]
    n = cfg["rows"]
    levels = assign_levels(n, 1.0 / math.log(2.0), 42,
                           max_cap=max(int(math.log2(max(n, 2))), 1))
    print(json.dumps({"rows_by_level": [int((levels >= l).sum())
                                        for l in range(levels.max() + 1)],
                      "LARGE_N": build_large.LARGE_N}), flush=True)
    family = load_family(cfg["index"]["family"])
    dev = torch.device("cuda")
    corpus, _ = make_data(cfg, args.seed)
    real_wait = build_large._wait

    def build(waits: bool) -> dict:
        build_large._wait = real_wait if waits else (lambda d: None)
        tracing.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        index = family.build(corpus, cfg, dev)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        del index
        spans = {s.name: (s.end_ns - s.start_ns) / 1e9
                 for s in tracing.collect().spans
                 if s.name.startswith("hnsw.build")}
        return dict(waits=waits, seconds=seconds, spans=spans,
                    memory_peak_bytes=torch.cuda.max_memory_allocated(dev))

    print(json.dumps(dict(warm=True, **build(True))), flush=True)
    logging.getLogger(build_large.__name__).setLevel(logging.WARNING)
    got = {True: [], False: []}
    for i in range(args.pairs):
        for waits in ((True, False) if i % 2 == 0 else (False, True)):
            row = build(waits)
            got[waits].append(row["seconds"])
            print(json.dumps(row), flush=True)
    build_large._wait = real_wait
    on, off = statistics.median(got[True]), statistics.median(got[False])
    print(json.dumps({"median_on_s": on, "median_off_s": off,
                      "waits_share": on / off - 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

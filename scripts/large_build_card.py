#!/usr/bin/env python3
"""HNSW past LARGE_N on one CUDA card: the bucketed build and serving at
bench.py's scale-sweep sizes.

    python3 scripts/large_build_card.py [--rows 1000000] [--profile]

Runs chip_smoke.large_path at --rows (default 1,000,000): bench.py's corpus
recipe for its scale sweep (generate_vectors, "embedding", 64 clusters,
seed 7), the exact f32 flat index as ground truth for 1,024 corpus rows,
build_hnsw_index with bench.py's settings for the size (bench.py:443-455:
M=16, one layer, pack_dim=128, 4 probes; 2 refine rounds up to 600,000 rows
and 3 past), serving at B=1,024 in four modes (recall@10, bar 0.95 at
accurate; qps_device), and the hop kernel of the pack held against its
plain version at the pack's shape. Past about 774,000 rows the bf16 pack
exceeds PACK_BYTES_CAP (models/hnsw/shadow.py), so the pack is int8 and the
kernel is hop_score_int8. It prints the same [large] lines as phase 8 of
chip_smoke.py, the card's name and power limit first.

--profile builds once more under torch.profiler, one profiler run per build
stage, and prints each stage's device time and idle share (1 - device time
/ wall time; the card runs one stream), as scripts/profile_torch_port.py
measures them. Profiling slows the host, so those wall times are not the
build's. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profiled_build(torch, n: int, refine_rounds: int) -> None:
    """The build of large_path again, each stage under its own
    torch.profiler run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import build_hnsw_index
    from hnsw_tpu_torch.types import Corpus

    data = generate_vectors(n, chip_smoke.DIM, distribution="embedding",
                            num_clusters=64, seed=chip_smoke.LARGE_SEED)
    corpus = Corpus.from_array(data, metric="cosine")
    del data
    torch.cuda.synchronize()
    rows = {}
    state = {"stage": "start", "prof": None, "t0": 0.0}

    def close():
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t0"]
        state["prof"].stop()
        events = [e for e in state["prof"].key_averages()
                  if e.device_type != DeviceType.CPU
                  and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in events) / 1e3
        top = max(events, key=lambda e: e.self_device_time_total,
                  default=None)
        row = rows.setdefault(state["stage"], dict(
            wall_ms=0.0, device_ms=0.0, top_device_op=None, top_ms=0.0))
        row["wall_ms"] += wall * 1e3
        row["device_ms"] += dev
        if top is not None and top.self_device_time_total / 1e3 > \
                row["top_ms"]:
            row["top_device_op"] = top.key[:60]
            row["top_ms"] = top.self_device_time_total / 1e3

    def open_(stage):
        state["stage"] = stage
        state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        state["prof"].start()
        state["t0"] = time.perf_counter()

    def progress(stage, frac):
        close()
        open_(stage)

    open_("start")
    build_hnsw_index(corpus, progress=progress,
                     large_refine_rounds=refine_rounds,
                     **chip_smoke.LARGE_BUILD)
    close()
    for stage, row in rows.items():
        row["device_idle_share"] = (1 - row["device_ms"] / row["wall_ms"]
                                    if row["wall_ms"] > 0 else None)
        chip_smoke.say("large_profile", stage=stage, **row)
    wall = sum(r["wall_ms"] for r in rows.values())
    dev = sum(r["device_ms"] for r in rows.values())
    chip_smoke.say("large_profile", stage="build", wall_ms=wall,
                   device_ms=dev, device_idle_share=1 - dev / wall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("large_build_card: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)
    from hnsw_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _cuda.library("hop.cu")
    chip_smoke.say("env", torch=torch.__version__, cuda=torch.version.cuda,
                   device=torch.cuda.get_device_name(0),
                   kernel_build_seconds=time.perf_counter() - t0)
    # bench.py:451-455: one more NN-descent round past 600,000 rows
    rounds = 3 if args.rows > 600_000 else 2
    t0 = time.perf_counter()
    chip_smoke.large_path(torch, n=args.rows, refine_rounds=rounds)
    chip_smoke.say("large", seconds=time.perf_counter() - t0)
    if args.profile:
        torch.cuda.empty_cache()
        profiled_build(torch, args.rows, rounds)
    print(json.dumps({"ok": True, "rows": args.rows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

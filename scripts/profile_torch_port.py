#!/usr/bin/env python3
"""Where the time goes in the PyTorch / CUDA port's main path, on one card.

    python3 scripts/profile_torch_port.py

Builds the 31,173 x 768 embedding-like stand-in corpus (cosine) and its HNSW
graph (M=16) with hnsw_tpu_torch, then for each workload runs a few batches
under torch.profiler and prints one JSON line: the host wall time per batch
(synchronized), the device time per batch summed over kernels, the device's
idle share (1 - device time / wall time; kernels run on one stream), the
kernels that take the most device time, and, without the profiler, the
median wall time of synchronized batches and the device span of a batch
between two CUDA events. HNSW serving runs with sampled and hierarchy
entries, at B=1,024 and B=32. Needs a CUDA card; imports no JAX.

It reads only the package's public entry points, so the same file can time
an older tree: copy it into that tree's scripts/ and run it there.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCHES = 3
UNPROFILED = 5


def profile(torch, label, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / BATCHES
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events) / BATCHES
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    walls, spans = [], []
    for _ in range(UNPROFILED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
    print(json.dumps({
        "workload": label,
        "wall_ms_per_batch": wall * 1e3,
        "device_ms_per_batch": busy_us / 1e3 if events else None,
        "device_idle_share": (1 - busy_us / 1e6 / wall) if events else None,
        "wall_ms_unprofiled": statistics.median(walls),
        "event_ms_unprofiled": statistics.median(spans),
        "device_idle_share_unprofiled": (
            1 - busy_us / 1e3 / statistics.median(walls)) if events else None,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_batch": e.self_device_time_total / 1e3
                         / BATCHES,
                         "calls_per_batch": e.count / BATCHES}
                        for e in top],
    }), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import FlatIndex, HNSWIndex, build_hnsw_index
    from hnsw_tpu_torch.types import Corpus

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    data = generate_vectors(31173, 768, distribution="embedding",
                            num_clusters=64, seed=42)
    corpus = Corpus.from_array(data, metric="cosine")
    q4096 = corpus.pad_queries(data[:4096])
    q1024 = q4096[:1024]
    for label, precision, fetch in (("flat_f32", "f32", None),
                                    ("flat_bf16", "bf16", None),
                                    ("flat_int8", "int8", None),
                                    ("flat_int8_coarse", "int8", 0)):
        idx = FlatIndex(corpus, precision=precision, int8_fetch=fetch)
        profile(torch, f"{label} B=4096", lambda: idx.search_batch(q4096, 10))
    graph = build_hnsw_index(corpus, M=16).graph
    profile(torch, "hnsw_build M=16",
            lambda: build_hnsw_index(corpus, M=16))
    for pp in ("bf16", "int8"):
        for entries in ("sample", "hierarchy"):
            idx = HNSWIndex(corpus, graph, entry_sample=2048,
                            pack_precision=pp, entry_mode=entries)
            for mode, b in (("turbo", 1024), ("balanced", 1024),
                            ("balanced", 32)):
                if entries == "hierarchy" and mode == "turbo":
                    continue
                q = q1024[:b]
                label = "" if entries == "sample" else " hierarchy"
                profile(torch, f"hnsw_{pp}_pack{label} {mode} B={b}",
                        lambda: idx.search_batch(q, 10, mode))
            del idx
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

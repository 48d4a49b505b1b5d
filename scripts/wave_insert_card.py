#!/usr/bin/env python3
"""Grow an HNSW index by one wave insert with the port, and save the graph
before and after for the JAX package to grow the same way.

    python3 scripts/wave_insert_card.py --out WAVE.npz

The setting of chip_smoke.py's phase 5 (d): the 31,173 x 768 stand-in corpus
(cosine), an HNSW index (M=16) built on the CUDA card over its first 30,149
rows, then one `add_batch` of the last 1,024. Prints, for the inserted rows
searched as queries (k=10, `balanced`) at `entry_sample` 512 and 2048,
recall@10 against the exact f32 flat index and the share whose own row
comes first. The .npz holds the graph before the insert and after it
(to_state arrays and params) and each run's rows, so that
scripts/wave_insert_reference.py can run the JAX insert on the identical
graph and wave and compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, SEED, K, WAVE = 31173, 768, 42, 10, 1024
SAMPLES = (512, 2048)
MODE = "balanced"


def save_state(out: dict, tag: str, state: dict) -> None:
    import numpy as np
    for k, v in state["arrays"].items():
        out[f"{tag}_arrays_{k}"] = v
    out[f"{tag}_params"] = np.array(json.dumps(state["params"]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="the .npz of both graphs and the port's rows")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wave_insert_card: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import FlatIndex, build_hnsw_index
    from hnsw_tpu_torch.types import Corpus

    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    n0 = N - WAVE
    index = build_hnsw_index(data[:n0], metric="cosine", M=16)
    out = {}
    save_state(out, "pre", index.to_state())
    index.add_batch(data[n0:])
    torch.cuda.synchronize()
    save_state(out, "post", index.to_state())

    new_q = data[n0:]
    _, truth = FlatIndex(Corpus.from_array(data, metric="cosine")) \
        .search_batch(new_q, K)
    own = torch.arange(n0, N, device=truth.device)
    for s in SAMPLES:
        index.entry_sample = s
        index._sample_rows = None
        _, rows = index.search_batch(new_q, K, MODE)
        hit = (rows[:, :, None] == truth[:, None, :]).any(-1) & (rows >= 0)
        out[f"rows_{s}"] = rows.cpu().numpy()
        print(json.dumps({
            "package": "hnsw_tpu_torch (card)", "entry_sample": s,
            "mode": MODE, "inserted": WAVE,
            "recall_at_10": float(hit.float().sum(-1).mean()) / K,
            "self_first": float((rows[:, 0] == own).float().mean())}),
            flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"saved {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Serve the 31,173 x 768 stand-in corpus with the port at two entry-sample
sizes, and save the graph and the result rows for the JAX package to search.

    python3 scripts/entry_sample_card.py --out GRAPH.npz

Builds `build_hnsw_index(corpus, M=16)` on the CUDA card (cosine, the corpus
of chip_smoke.py), searches 1024 corpus rows as queries (k=10) at `turbo`
and `balanced` with `entry_sample` 512 (the default) and 2048, and with
`entry_mode="hierarchy"` (the greedy descent from the graph's entry), and
prints
recall@10 against the exact f32 flat index and the share of queries whose
own row comes first. The .npz holds the graph (to_state arrays and params)
and each run's rows, so that scripts/entry_sample_reference.py can search
the identical graph with the JAX package and compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, SEED, K, NQ = 31173, 768, 42, 10, 1024
SAMPLES = (512, 2048, "hierarchy")
MODES = ("turbo", "balanced")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="the .npz of the graph and the port's rows")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("entry_sample_card: needs a CUDA card", file=sys.stderr)
        return 1
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import FlatIndex, HNSWIndex, build_hnsw_index
    from hnsw_tpu_torch.types import Corpus

    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    corpus = Corpus.from_array(data, metric="cosine")
    q = corpus.pad_queries(data[:NQ])
    _, truth = FlatIndex(corpus).search_batch(q, K)
    built = build_hnsw_index(corpus, M=16)
    state = built.to_state()
    out = {f"arrays_{k}": v for k, v in state["arrays"].items()}
    out["params"] = np.array(json.dumps(state["params"]))
    own = torch.arange(NQ, device=q.device)
    for s in SAMPLES:
        index = HNSWIndex(corpus, built.graph, **(
            dict(entry_mode="hierarchy") if s == "hierarchy"
            else dict(entry_sample=s)))
        for mode in MODES:
            _, rows = index.search_batch(q, K, mode)
            hit = (rows[:, :, None] == truth[:, None, :]).any(-1) & (rows >= 0)
            rec = float(hit.float().sum(-1).mean()) / K
            self_first = float((rows[:, 0] == own).float().mean())
            out[f"rows_{s}_{mode}"] = rows.cpu().numpy()
            print(json.dumps({"package": "hnsw_tpu_torch (card)",
                              "entry_sample": s, "mode": mode,
                              "recall_at_10": rec,
                              "self_first": self_first}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"saved {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

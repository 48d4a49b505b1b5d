#!/usr/bin/env python3
"""Search the graph that scripts/entry_sample_card.py built on the card with
the JAX package (the reference), on the CPU, and compare with the port.

    JAX_PLATFORMS=cpu python3 scripts/entry_sample_reference.py \
        --npz GRAPH.npz [--batch 64]

Regenerates the same 31,173 x 768 stand-in corpus with the JAX package's own
generator, loads the graph with `HNSWIndex.from_state`, and searches the
same 1024 corpus rows (k=10) at the same modes, entry-sample sizes and
hierarchy entries. The
search runs in batches of `--batch` queries without the neighbour pack,
which keeps the process near 1.1 GiB at its peak; a query's result does
not depend on its batch, and the unpacked path scores the same bf16
products as the packed one. Prints, per run, the reference's recall@10 against an exact
numpy f32 scan, its self-first share, the port's self-first share, and the
share of queries whose rows are identical in both packages. Imports no torch.
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
    ap.add_argument("--npz", required=True,
                    help="the .npz of the graph and the port's rows")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()

    import numpy as np
    from hnsw_tpu.io.datagen import generate_vectors
    from hnsw_tpu.models.hnsw import HNSWIndex
    from hnsw_tpu.types import Corpus

    saved = np.load(args.npz)
    state = {"params": json.loads(str(saved["params"])),
             "arrays": {k[len("arrays_"):]: saved[k] for k in saved.files
                        if k.startswith("arrays_")}}
    data = np.asarray(generate_vectors(N, DIM, distribution="embedding",
                                       num_clusters=64, seed=SEED),
                      np.float32)
    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    sims = unit[:NQ] @ unit.T
    truth = np.argsort(-sims, axis=1, kind="stable")[:, :K]
    del sims

    corpus = Corpus.from_array(data, metric="cosine")
    index = HNSWIndex.from_state(corpus, state)
    index.pack = False
    for s in SAMPLES:
        if s == "hierarchy":
            index.entry_mode = "hierarchy"
        else:
            index.entry_sample = s
            index._sample_rows = None
        for mode in MODES:
            rows = np.concatenate([
                np.asarray(index.search_batch(data[i:i + args.batch], K,
                                              mode)[1])
                for i in range(0, NQ, args.batch)])
            port = saved[f"rows_{s}_{mode}"]
            hit = (rows[:, :, None] == truth[:, None, :]).any(-1) & (rows >= 0)
            print(json.dumps({
                "package": "hnsw_tpu (JAX, CPU)", "entry_sample": s,
                "mode": mode, "recall_at_10": float(hit.sum(-1).mean()) / K,
                "self_first": float((rows[:, 0] == np.arange(NQ)).mean()),
                "port_self_first": float(
                    (port[:, 0] == np.arange(NQ)).mean()),
                "rows_identical": float((rows == port).all(1).mean()),
                "self_missed_by_both": int(
                    ((rows[:, 0] != np.arange(NQ))
                     & (port[:, 0] != np.arange(NQ))).sum()),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

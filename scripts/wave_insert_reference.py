#!/usr/bin/env python3
"""Run the JAX package's wave insert (the reference) on the graph and wave
that scripts/wave_insert_card.py used on the card, on the CPU, and compare
with the port.

    JAX_PLATFORMS=cpu python3 scripts/wave_insert_reference.py \
        --npz WAVE.npz [--batch 64]

Regenerates the 31,173 x 768 stand-in corpus with the JAX package's own
generator, loads the saved 30,149-row graph with `HNSWIndex.from_state`, and
grows it with `add_batch` by the same 1,024 rows. Prints how far the two
packages' graphs agree (levels, entry, and for the inserted rows and for
the rows the insert re-pruned: the share of layer-0 neighbour lists that
are identical, in order and as sets, and the share of edges in common),
and for the inserted rows of each upper layer, then, at `entry_sample` 512
and 2048 (`balanced`, k=10), the self-first
share and recall@10 of the inserted rows searched by the JAX package on its
own graph and on the port's graph, beside the port's own shares. The
searches run in batches of `--batch` queries without the neighbour pack,
as scripts/entry_sample_reference.py does. Imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, SEED, K, WAVE = 31173, 768, 42, 10, 1024
SAMPLES = (512, 2048)
MODE = "balanced"


def load_state(saved, tag: str) -> dict:
    prefix = f"{tag}_arrays_"
    return {"params": json.loads(str(saved[f"{tag}_params"])),
            "arrays": {k[len(prefix):]: saved[k] for k in saved.files
                       if k.startswith(prefix)}}


def list_agreement(a, b, rows) -> dict:
    """Agreement of two [n, cap] neighbour tables on `rows`."""
    import numpy as np
    a, b = a[rows], b[rows]
    same_order = (a == b).all(1)
    sa = np.sort(a, axis=1)
    sb = np.sort(b, axis=1)
    same_set = (sa == sb).all(1)
    common = sum(len(np.intersect1d(x[x >= 0], y[y >= 0]))
                 for x, y in zip(a, b))
    edges = int((b >= 0).sum())
    return {"rows": int(len(rows)), "identical": float(same_order.mean()),
            "same_set": float(same_set.mean()),
            "edges_in_common": common / max(edges, 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", required=True,
                    help="the .npz of both graphs and the port's rows")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()

    import numpy as np
    from hnsw_tpu.io.datagen import generate_vectors
    from hnsw_tpu.models.hnsw import HNSWIndex
    from hnsw_tpu.types import Corpus

    saved = np.load(args.npz)
    pre, post = load_state(saved, "pre"), load_state(saved, "post")
    data = np.asarray(generate_vectors(N, DIM, distribution="embedding",
                                       num_clusters=64, seed=SEED),
                      np.float32)
    n0 = N - WAVE
    ref = HNSWIndex.from_state(Corpus.from_array(data[:n0], metric="cosine"),
                               pre)
    t0 = time.perf_counter()
    ref.add_batch(data[n0:])
    insert_s = time.perf_counter() - t0

    mine = {k: np.asarray(v) for k, v in ref.to_state()["arrays"].items()}
    port = post["arrays"]
    rp, pp = ref.to_state()["params"], post["params"]
    new_rows = np.arange(n0, N)
    old0 = pre["arrays"]["adj0"]
    touched = np.nonzero((port["adj0"][:n0] != old0[:n0]).any(1)
                         | (mine["adj0"][:n0] != old0[:n0]).any(1))[0]
    print(json.dumps({
        "what": "graph after the wave insert, JAX against the port",
        "jax_insert_seconds": insert_s,
        "levels_identical": bool(np.array_equal(mine["levels"],
                                                port["levels"])),
        "entry": [rp["entry"], pp["entry"]],
        "max_level": [rp["max_level"], pp["max_level"]],
        "adj_upper_identical": bool(np.array_equal(mine["adj_upper"],
                                                   port["adj_upper"])),
        "adj_upper_inserted": [
            list_agreement(mine["adj_upper"][l], port["adj_upper"][l],
                           new_rows[mine["levels"][new_rows] > l])
            for l in range(mine["adj_upper"].shape[0])
            if (mine["levels"][new_rows] > l).any()],
        "adj0_inserted": list_agreement(mine["adj0"], port["adj0"], new_rows),
        "adj0_repruned": list_agreement(mine["adj0"], port["adj0"], touched),
    }), flush=True)

    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    truth = np.argsort(-(unit[n0:] @ unit.T), axis=1, kind="stable")[:, :K]
    corpus = Corpus.from_array(data, metric="cosine")
    graphs = {"jax_graph": ref,
              "port_graph": HNSWIndex.from_state(corpus, post)}
    for s in SAMPLES:
        port_rows = saved[f"rows_{s}"]
        line = {"entry_sample": s, "mode": MODE,
                "port_self_first": float((port_rows[:, 0] == new_rows)
                                         .mean())}
        for name, index in graphs.items():
            index.pack = False
            index.entry_sample = s
            index._sample_rows = None
            rows = np.concatenate([
                np.asarray(index.search_batch(data[i:i + args.batch], K,
                                              MODE)[1])
                for i in range(n0, N, args.batch)])
            hit = (rows[:, :, None] == truth[:, None, :]).any(-1) & (rows >= 0)
            line[f"{name}_self_first"] = float((rows[:, 0] == new_rows).mean())
            line[f"{name}_recall_at_10"] = float(hit.sum(-1).mean()) / K
            line[f"{name}_rows_identical_to_port"] = float(
                (rows == port_rows).all(1).mean())
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

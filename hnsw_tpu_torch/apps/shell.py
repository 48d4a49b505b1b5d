"""Interactive search shell — the reference's main.clj serving UX.
Counterpart of ``hnsw_tpu/apps/shell.py``.

main.clj:143-258: load the corpus JSON, build a partitioned index, then a
REPL loop: free text -> substring match finds a seed document -> its
embedding becomes the query -> results rendered with similarity % =
100 * (1 - distance) (main.clj:18-62). Commands: `recall`, `benchmark`,
`stats`, `mode 1-3` (plus named modes here), `quit`.

Usage: python -m hnsw_tpu_torch.apps.shell [corpus.json] [--index hnsw]
                                           [--device cpu]
       (falls back to a synthetic corpus when no JSON is found; runs on the
       CUDA card unless --device names another device)
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np

from hnsw_tpu_torch.bench.harness import (run_recall_benchmark,
                                          run_search_benchmark)
from hnsw_tpu_torch.config import Mode
from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.io.loader import (get_best_available_data,
                                      load_json_corpus)
from hnsw_tpu_torch.models import FAMILIES
from hnsw_tpu_torch.models.flat import FlatIndex

MODE_NUMBERS = {"1": Mode.TURBO, "2": Mode.BALANCED, "3": Mode.PRECISE}


class SearchShell:
    def __init__(self, corpus_path: Optional[str] = None,
                 index_type: str = "hnsw", n_synthetic: int = 5000,
                 device=None):
        pairs, texts = None, {}
        if corpus_path:
            pairs, texts, _ = load_json_corpus(corpus_path)
        else:
            found = get_best_available_data()
            if found:
                pairs, texts, _, corpus_path = found
        if pairs:
            print(f"Loaded {len(pairs)} vectors from {corpus_path}")
            data = np.stack([p[1] for p in pairs])
            ids = [p[0] for p in pairs]
        else:
            print(f"No corpus found; using synthetic {n_synthetic}x768")
            data = generate_vectors(n_synthetic, 768,
                                    distribution="clustered", num_clusters=32)
            ids = [f"doc_{i}" for i in range(n_synthetic)]
            texts = {i: f"synthetic document {i}" for i in ids}

        print(f"Building {index_type} index...")
        t0 = time.perf_counter()
        self.index = FAMILIES[index_type](data, ids=ids, device=device)
        print(f"Built in {time.perf_counter() - t0:.2f}s")
        self.data = data
        self.ids = ids
        self.texts: Dict[str, str] = texts
        self.id_pos = {i: p for p, i in enumerate(ids)}
        self.mode = Mode.BALANCED
        # warm up (main.clj:204-210)
        self.index.search_batch(data[:1], 10, self.mode)

    def find_seed(self, text: str) -> Optional[str]:
        """Substring match over document texts/ids (main.clj:18-35)."""
        needle = text.lower()
        for vid, t in self.texts.items():
            if needle in str(t).lower():
                return vid
        for vid in self.ids:
            if needle in str(vid).lower():
                return vid
        return None

    def query(self, text: str, k: int = 10):
        vid = self.find_seed(text)
        if vid is None:
            print(f"no document matches {text!r}")
            return
        qvec = self.data[self.id_pos[vid]]
        t0 = time.perf_counter()
        hits = self.index.search(qvec, k, self.mode)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"seed: {vid}  ({ms:.2f} ms)")
        for h in hits:
            sim = 100.0 * (1.0 - h["distance"])  # main.clj:52-62
            txt = str(self.texts.get(h["id"], ""))[:70]
            print(f"  {sim:6.2f}%  {h['id']:>14s}  {txt}")

    def stats(self):
        for k, v in self.index.index_info().items():
            print(f"  {k}: {v}")

    def recall(self):
        exact = FlatIndex(self.index.corpus)
        rec = run_recall_benchmark(self.index, self.data, mode=self.mode,
                                   num_queries=50, exact_index=exact)
        print(f"  recall@10 ({self.mode.value}): {rec['recall_at_k']:.4f}")

    def benchmark(self):
        perf = run_search_benchmark(self.index, self.data[:512],
                                    mode=self.mode, batch_size=256, iters=5,
                                    single_query_iters=10)
        print(f"  QPS(batched): {perf['qps_batched']:.0f}   "
              f"p50 {perf['p50_ms']:.3f}ms  p99 {perf['p99_ms']:.3f}ms")

    def run(self):
        print("commands: <free text> | recall | benchmark | stats | "
              "mode <1-3|turbo..precise> | quit")
        while True:
            try:
                line = input("search> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not line:
                continue
            if line in ("quit", "exit"):
                break
            if line == "stats":
                self.stats()
            elif line == "recall":
                self.recall()
            elif line == "benchmark":
                self.benchmark()
            elif line.startswith("mode"):
                arg = line.split(maxsplit=1)[1] if " " in line else "2"
                self.mode = MODE_NUMBERS.get(arg) or Mode.coerce(arg)
                print(f"  mode = {self.mode.value}")
            else:
                self.query(line)
        print("bye")


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    path = None
    index_type = "hnsw"
    device = None
    while args:
        a = args.pop(0)
        if a == "--index":
            index_type = args.pop(0)
        elif a == "--device":
            device = args.pop(0)
        else:
            path = a
    SearchShell(path, index_type, device=device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())

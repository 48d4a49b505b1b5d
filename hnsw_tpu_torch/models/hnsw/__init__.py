"""HNSW index family. Counterpart of ``hnsw_tpu/models/hnsw/__init__.py``:
exact-candidate build and wave insert (build.py), the bucketed builder past
LARGE_N rows (build_large.py) and batched fixed-beam search (search.py).
Mode presets map to ef as in ``config.HNSW_EF``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import DEFAULTS, Mode, ef_for
from hnsw_tpu_torch.models.base import ANNIndex
from hnsw_tpu_torch.models.common import as_corpus
from hnsw_tpu_torch.models.hnsw.build import build_graph, insert_wave
from hnsw_tpu_torch.models.hnsw.graph import (HNSWGraph, assign_levels,
                                              empty_graph)
from hnsw_tpu_torch.models.hnsw.search import (_search_batch,
                                               hnsw_search_batch,
                                               sample_entries)
from hnsw_tpu_torch.models.hnsw.shadow import HopShadow
from hnsw_tpu_torch.types import Corpus
from hnsw_tpu_torch.utils import tracing
from hnsw_tpu_torch.utils.graphs import CapturedCall


class HNSWIndex(ANNIndex):
    family = "hnsw"

    # captured searches kept on the card, the least recently used dropped
    # first (each holds its own memory pool)
    GRAPH_CACHE = 8

    def __init__(self, corpus: Corpus, graph: HNSWGraph, *,
                 expand: int = 4, entry_mode: str = "sample",
                 entry_sample: int = 512, precision: str = "auto",
                 pack: str | bool = "auto",
                 pack_dim: Optional[int] = None, rerank_mult: int = 4,
                 pack_precision: str = "auto"):
        super().__init__(corpus)
        self.graph = graph
        self.expand = expand
        self.entry_mode = entry_mode
        self.entry_sample = entry_sample
        # read by HopShadow.prepare at every search, so they may change on a
        # built index; a used pack is scored by ops/hop.py
        self.precision = precision
        self.pack = pack
        self.pack_precision = pack_precision
        self.pack_dim = pack_dim
        self.rerank_mult = rerank_mult
        self._sample_rows = None
        self._shadow = HopShadow()    # what the hop loop scores against
        self._graphs = OrderedDict()

    def _entry_rows(self) -> torch.Tensor:
        if self._sample_rows is None or \
                self._sample_rows.shape[0] > max(self.graph.n, 1):
            s = min(self.entry_sample, max(self.graph.n, 1))
            rows = np.unique(np.linspace(0, max(self.graph.n - 1, 0), s)
                             .astype(np.int32))
            self._sample_rows = torch.from_numpy(rows).to(self.corpus.device)
        return self._sample_rows

    def search_batch(self, queries, k: int, mode: Mode = Mode.BALANCED,
                     ef: Optional[int] = None, debug_hops: bool = False):
        """On the card the search is replayed from a CUDA graph captured at
        the first call of each (batch shape, k, ef, mode-derived settings,
        pack kind, device tracing); the CPU runs it directly. Records the
        spans hnsw.search (the call; attributes batch and captured) and
        inside it hnsw.search.pad (the queries to the device), .prepare
        (the settings, and any shadow or pack they need), .capture (a
        key's first call on the card) and CapturedCall's .replay and
        .clone."""
        captured = self.corpus.device.type == "cuda"
        with tracing.span("hnsw.search", captured=captured) as root:
            with tracing.span("hnsw.search.pad"):
                q = self.corpus.pad_queries(queries)
            root.attrs["batch"] = q.shape[0]
            dev = q.device
            if self.graph.n == 0 or self.graph.entry < 0:
                b = q.shape[0]
                out = (torch.full((b, k), float("inf"), device=dev),
                       torch.full((b, k), -1, dtype=torch.int32, device=dev))
                return out + (0,) if debug_hops else out
            with tracing.span("hnsw.search.prepare"):
                run, key = self._search_fn(k, mode, ef, debug_hops)
            if dev.type != "cuda":
                d, r, hops = run(q)
            else:
                key = (tuple(q.shape),) + key
                call = self._graphs.pop(key, None)
                if call is None:
                    while len(self._graphs) >= self.GRAPH_CACHE:
                        self._graphs.popitem(last=False)
                    with tracing.span("hnsw.search.capture"):
                        call = CapturedCall(run, q)
                self._graphs[key] = call        # the most recently used last
                d, r, hops = call(q)
            return (d, r, int(hops)) if debug_hops else (d, r)

    def _drop_graphs(self):
        """Forget every captured search: each replays on the tensors it was
        captured with (the shadow, pack, projection, graph and corpus)."""
        self._graphs.clear()

    def _search_fn(self, k: int, mode: Mode, ef: Optional[int],
                   debug_hops: bool):
        """The search of a batch as a function of the padded queries alone,
        with every host decision taken and every cached shadow, pack and
        entry sample built here, ahead of any capture. Returns (run, key):
        run(q) -> (dists, rows, hops) and the settings that fix it, which
        end in "device_tracing" while the tracer's device marks are on
        (a graph captured with them holds their kernels)."""
        ef = ef if ef is not None else ef_for(mode, k)
        route = self._shadow.prepare(
            self.corpus, self.graph.adj0, precision=self.precision,
            pack=self.pack, pack_precision=self.pack_precision,
            pack_dim=self.pack_dim)
        if route.rebuilt:
            self._drop_graphs()
        vectors, v_sq = self.corpus.vectors, self.corpus.sq_norms
        metric = self.corpus.metric
        hierarchy = self.entry_mode != "sample"
        sample_rows = None if hierarchy else self._entry_rows()
        kw = dict(
            k=k, ef=ef, expand=self.expand, metric=metric,
            # re-ranking a rerank_mult*k beam prefix exactly recovers the
            # near-ties the bf16 shadow reorders
            rerank=self.rerank_mult * k, debug_hops=debug_hops,
            **route.kwargs)
        graph, proj = self.graph, route.proj

        def run(q):
            tracing.mark("entry", q.device)
            if hierarchy:
                entries = torch.full((q.shape[0],), graph.entry,
                                     dtype=torch.int32, device=q.device)
                upper = graph.adj_upper
            else:
                # one product against a row sample replaces the serial
                # upper-layer descent; entry_mode="hierarchy" walks the
                # layers
                entries, _ = sample_entries(vectors, v_sq, sample_rows, q,
                                            metric=metric)
                upper = graph.adj_upper[:0]
            return _search_batch(
                vectors, v_sq, graph.adj0, upper, entries, q,
                queries_lp=None if proj is None else torch.matmul(q, proj),
                **kw)

        key = (k, ef, route.precision, hierarchy, self.expand,
               self.rerank_mult, route.pack, route.loop_dim, debug_hops)
        if tracing.device_tracing():
            key += ("device_tracing",)
        return run, key

    def add_batch(self, data, ids=None, *, seed_offset: int = 0):
        """Append new vectors and connect them with a batched wave insert
        (build.insert_wave). The corpus is repacked on its device, and every
        cached shadow, pack and entry sample is dropped, as the grown corpus
        and graph invalidate them all."""
        data = np.atleast_2d(np.asarray(data, np.float32))
        w = data.shape[0]
        old_n = self.corpus.n
        old = self.corpus.vectors[:old_n, : self.corpus.dim].cpu().numpy()
        merged = np.concatenate([old, data], axis=0)
        new_ids = None
        if self.corpus.ids is not None or ids is not None:
            olds = list(self.corpus.ids) if self.corpus.ids is not None else \
                [str(i) for i in range(old_n)]
            news = [str(i) for i in (ids if ids is not None
                                     else range(old_n, old_n + w))]
            new_ids = olds + news
        self.corpus = Corpus.from_array(merged, metric=self.corpus.metric,
                                        ids=new_ids, device=self.corpus.device)
        self._sample_rows = None   # the entry sample must cover the new rows
        self._shadow = HopShadow()  # the old corpus's shadow and pack
        self._drop_graphs()        # they replay on the old corpus and graph
        new_rows = np.arange(old_n, old_n + w, dtype=np.int32)
        new_levels = assign_levels(w, DEFAULTS["ml"],
                                   DEFAULTS["seed"] + old_n + seed_offset)
        if self.graph.n == 0:
            self.graph = build_graph(
                self.corpus, m=self.graph.m, m0=self.graph.m0,
                ef_construction=self.graph.ef_construction)
        else:
            self.graph = insert_wave(self.graph, self.corpus, new_rows,
                                     new_levels)
        return self

    def index_info(self) -> Dict[str, Any]:
        info = self.graph.info()
        info.update({
            "type": self.family,
            "num_vectors": self.corpus.n,
            "dimensions": self.corpus.dim,
            "metric": self.corpus.metric.value,
        })
        return info

    def to_state(self) -> Dict[str, Any]:
        g = self.graph
        return {
            "params": {
                "M": g.m, "M0": g.m0, "ef_construction": g.ef_construction,
                "entry": int(g.entry), "max_level": int(g.max_level),
                "n": int(g.n), "expand": self.expand,
                "n_bridges": int(g.n_bridges),
            },
            "arrays": {
                "levels": g.levels.cpu().numpy(),
                "adj0": g.adj0.cpu().numpy(),
                "adj_upper": g.adj_upper.cpu().numpy(),
            },
        }

    @classmethod
    def from_state(cls, corpus: Corpus, state: Dict[str, Any],
                   **kwargs) -> "HNSWIndex":
        """Rebuild an index over `corpus` from a to_state() dict (numpy
        arrays, as either package writes them); kwargs go to __init__."""
        p, a = state["params"], state["arrays"]
        dev = corpus.device

        def arr(name):
            return torch.from_numpy(
                np.array(a[name], dtype=np.int32)).to(dev)

        graph = HNSWGraph(
            levels=arr("levels"), adj0=arr("adj0"), adj_upper=arr("adj_upper"),
            entry=int(p["entry"]), max_level=int(p["max_level"]),
            m=int(p["M"]), m0=int(p["M0"]),
            ef_construction=int(p["ef_construction"]), n=int(p["n"]),
            n_bridges=int(p.get("n_bridges", 0)),
        )
        kwargs.setdefault("expand", int(p.get("expand", 4)))
        return cls(corpus, graph, **kwargs)


def build_hnsw_index(
    data,
    *,
    M: int = DEFAULTS["M"],
    max_M0: Optional[int] = None,
    ef_construction: int = DEFAULTS["ef_construction"],
    metric="cosine",
    ids=None,
    seed: int = DEFAULTS["seed"],
    k_cand: Optional[int] = None,
    expand: int = 4,
    pack_dim: Optional[int] = None,
    pack_precision: str = "auto",
    rerank_mult: int = 4,
    large_probe_clusters: int = 2,
    large_refine_rounds: int = 1,
    hierarchy: bool = True,
    progress=None,
    should_continue=None,
    device=None,
    **_ignored,
) -> HNSWIndex:
    """Build an HNSW index from [n, dim] arrays, [id, vec] pairs, or a
    Corpus, on the CUDA card unless device says otherwise."""
    corpus = as_corpus(data, metric=metric, ids=ids, device=device)
    if corpus.n == 0:
        graph = empty_graph(corpus.n_pad or 8, M, max_M0 or 2 * M, 0,
                            ef_construction, device=corpus.device)
    else:
        graph = build_graph(corpus, m=M, m0=max_M0,
                            ef_construction=ef_construction,
                            seed=seed, k_cand=k_cand,
                            large_probe_clusters=large_probe_clusters,
                            large_refine_rounds=large_refine_rounds,
                            hierarchy=hierarchy,
                            progress=progress, should_continue=should_continue)
    return HNSWIndex(corpus, graph, expand=expand, pack_dim=pack_dim,
                     pack_precision=pack_precision, rerank_mult=rerank_mult)


__all__ = ["HNSWIndex", "build_hnsw_index", "HNSWGraph", "build_graph",
           "insert_wave", "hnsw_search_batch"]

"""The flagship step: the twin of ``__graft_entry__.entry``.

``entry()`` returns ``(fn, args)``: the whole batched HNSW search with the
hierarchy descent, ``fn(*args)``, on a small index built from a seed. The
reference's ``fn`` is jittable; this one runs on the card with no host
synchronisation (``models/hnsw/search.py``), so it can be captured in one
CUDA graph (``utils/graphs.CapturedCall``). The multi-device step,
``dryrun_multichip``, is ``parallel/dryrun.py``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch


def _tiny_data(n=512, dim=64, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def entry(device=None):
    """(fn, args): full-hierarchy batched HNSW beam search of 32 of the
    corpus's rows on a 512 x 64 index built with M=8, each query entered at
    the graph's entry point. On the CUDA card unless device says
    otherwise."""
    from hnsw_tpu_torch.models.hnsw import build_hnsw_index
    from hnsw_tpu_torch.models.hnsw.search import hnsw_search_batch

    data = _tiny_data(512, 64)
    idx = build_hnsw_index(data, M=8, device=device)
    g = idx.graph
    c = idx.corpus
    b = 32
    queries = c.pad_queries(data[:b])
    entries = torch.full((b,), g.entry, dtype=torch.int32, device=c.device)

    fn = partial(hnsw_search_batch, k=10, ef=64, metric=c.metric)
    args = (c.vectors, c.sq_norms, g.adj0, g.adj_upper, entries, queries)
    return fn, args

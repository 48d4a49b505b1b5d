"""Corpus loaders (copy of ``hnsw_tpu/io/loader.py``) — the reference's JSON
corpus loading semantics.

helper/data_loader.clj:7-61 loads a JSON file of shape
{"metadata": {...}, "verses": [{"id", "book", "chapter", "verse", "text",
"embedding"}, ...]} (produced by scripts/export_complete_bible.py:73-128)
into [[id double-array] ...] pairs plus an id->text map, with OOM guidance
and a best-available fallback chain (complete -> 30000 -> 10000 -> base).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# data_loader.clj:43-61 fallback chain
DEFAULT_CANDIDATES = [
    "data/bible_embeddings_complete.json",
    "data/bible_embeddings_30000.json",
    "data/bible_embeddings_10000.json",
    "data/bible_embeddings.json",
]


def load_json_corpus(path: str):
    """Load a verses/vectors JSON corpus.

    Returns (pairs, texts, metadata) where pairs is the reference-native
    [[id, np.float32 array], ...], texts maps id -> display text (empty when
    the corpus has none), metadata is the file's metadata map.

    Large files go through the native C++ parser (native/fast_corpus.cpp)
    when available; any mismatch falls back to the Python json module.
    """
    try:
        if os.path.getsize(path) > 4 * 1024 * 1024:
            from hnsw_tpu_torch.io.native import parse_corpus
            parsed = parse_corpus(path)
            if parsed is not None:
                emb, ids, txts = parsed
                pairs = [[ids[i], emb[i]] for i in range(len(ids))]
                texts = {ids[i]: txts[i] for i in range(len(ids)) if txts[i]}
                return pairs, texts, {}
    except (OSError, MemoryError):
        pass
    try:
        with open(path) as f:
            payload = json.load(f)
    except MemoryError:
        # data_loader.clj:38-41 catches OOM and prints heap-size guidance
        raise MemoryError(
            f"out of memory loading {path}; load a smaller corpus from the "
            "fallback chain (get_best_available_data) or convert the JSON "
            "to .npz once and memory-map it") from None
    items = payload.get("verses") or payload.get("vectors") or []
    pairs: List[list] = []
    texts: Dict[str, str] = {}
    for it in items:
        vid = str(it.get("id"))
        emb = np.asarray(it["embedding"], np.float32)
        pairs.append([vid, emb])
        if "text" in it:
            texts[vid] = it["text"]
    return pairs, texts, payload.get("metadata", {})


def get_best_available_data(
    candidates: Optional[List[str]] = None, base_dir: str = "."
):
    """First loadable corpus from the fallback chain
    (data_loader.clj:43-61). Returns (pairs, texts, metadata, path) or None."""
    for rel in candidates or DEFAULT_CANDIDATES:
        p = rel if os.path.isabs(rel) else os.path.join(base_dir, rel)
        if os.path.exists(p):
            try:
                pairs, texts, meta = load_json_corpus(p)
                if pairs:
                    return pairs, texts, meta, p
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    return None

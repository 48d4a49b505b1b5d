"""Index persistence: versioned whole-index snapshots. Counterpart of
``hnsw_tpu/io/persist.py``, with the same two on-disk layouts and
FORMAT_VERSION, so that a file written by either package loads in the other.

- ``format="npz"``: one compressed ``.npz`` holding ``__header__`` (JSON:
  format_version, family, metric, n, dim, params, has_ids, has_metadata),
  ``__vectors__`` [n, dim] f32, ``__ids__`` (strings, when the index has
  ids), ``__metadata__`` (JSON, when given) and one ``arr_<name>`` per state
  array of the family.
- ``format="dir"``: a ``.idx`` directory with ``header.json``,
  ``metadata.json``, ``vectors.npy``, ``ids.npy`` and ``arr_<name>.npy``,
  loaded with numpy memory mapping and copied to the device in bounded row
  chunks (``Corpus.from_array_streamed``).

The header records the metric, the family and every build parameter, so a
load needs nothing but the path. Loads put the index on the CUDA card unless
the caller passes ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

FORMAT_VERSION = 2

# rows per host->device copy when staging a memory-mapped corpus: bounds
# transient host memory to chunk_rows * d_pad * 4 bytes
STREAM_CHUNK_ROWS = 65536


def save_index(index, path: str, *, metadata: Optional[dict] = None,
               format: str = "npz") -> str:
    """Snapshot an index. metadata: optional JSON-serializable per-id map
    stored with the index. format: "npz" (one compressed file) or "dir"
    (a raw .npy directory that loads memory-mapped). Returns the path
    written."""
    state = index.to_state()
    corpus = index.corpus
    header = {
        "format_version": FORMAT_VERSION,
        "family": index.family,
        "metric": corpus.metric.value,
        "n": corpus.n,
        "dim": corpus.dim,
        "params": _jsonable(state.get("params", {})),
        "has_ids": corpus.ids is not None,
        "has_metadata": bool(metadata),
    }
    arrays: dict[str, np.ndarray] = {
        "__vectors__": corpus.vectors[: corpus.n, : corpus.dim].cpu().numpy(),
    }
    if corpus.ids is not None:
        arrays["__ids__"] = np.asarray([str(i) for i in corpus.ids])
    for name, arr in state.get("arrays", {}).items():
        arrays[f"arr_{name}"] = np.asarray(arr)

    if format == "dir":
        d = path if path.endswith(".idx") else path + ".idx"
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "header.json"), "w") as f:
            json.dump(header, f)
        if metadata:
            with open(os.path.join(d, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        for name, arr in arrays.items():
            np.save(os.path.join(d, name.strip("_") + ".npy"), arr,
                    allow_pickle=False)
        return d
    if format != "npz":
        raise ValueError(f"unknown index format {format!r}")
    if metadata:
        arrays["__metadata__"] = np.asarray(json.dumps(metadata))
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, __header__=json.dumps(header), **arrays)
    return path


def load_index(path: str, *, return_metadata: bool = False,
               mmap: bool = True, stream_chunk_rows: int = STREAM_CHUNK_ROWS,
               device=None):
    """Load a saved index of any family; the metric and params come
    from the stored header. Accepts both layouts (.npz file or .idx
    directory); directory loads map the arrays (mmap=True) and copy the
    corpus to the device in `stream_chunk_rows` chunks. The index lands on
    the CUDA card unless `device` says otherwise. With return_metadata=True
    returns (index, metadata_dict)."""
    from hnsw_tpu_torch.types import Corpus

    d = _resolve_dir(path)
    if d is not None:
        header, vectors, ids, arrays, meta = _read_dir(d, mmap=mmap)
        corpus = Corpus.from_array_streamed(
            vectors, metric=header["metric"], ids=ids,
            chunk_rows=stream_chunk_rows, device=device)
    else:
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["__header__"]))
            _check_version(header)
            vectors = z["__vectors__"]
            ids = [str(s) for s in z["__ids__"]] \
                if header.get("has_ids") else None
            arrays = {k[4:]: z[k] for k in z.files if k.startswith("arr_")}
            meta = json.loads(str(z["__metadata__"])) \
                if "__metadata__" in z.files else {}
        corpus = Corpus.from_array(vectors, metric=header["metric"], ids=ids,
                                   device=device)
    cls = _index_class(header["family"])
    idx = cls.from_state(corpus, {"params": header.get("params", {}),
                                  "arrays": arrays})
    return (idx, meta) if return_metadata else idx


def _index_class(family: str):
    from hnsw_tpu_torch.models import INDEX_CLASSES
    if family not in INDEX_CLASSES:
        raise ValueError(f"unknown index family {family!r}")
    return INDEX_CLASSES[family]


def _check_version(header: dict) -> None:
    if header["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"index format {header['format_version']} is newer than "
            f"supported {FORMAT_VERSION}")


def _resolve_dir(path: str) -> Optional[str]:
    for cand in (path, path + ".idx"):
        if os.path.isdir(cand) and \
                os.path.exists(os.path.join(cand, "header.json")):
            return cand
    return None


def _read_dir(d: str, *, mmap: bool):
    with open(os.path.join(d, "header.json")) as f:
        header = json.load(f)
    _check_version(header)
    mode = "r" if mmap else None

    def arr(name):
        return np.load(os.path.join(d, name + ".npy"), mmap_mode=mode,
                       allow_pickle=False)

    vectors = arr("vectors")
    ids = [str(s) for s in np.load(os.path.join(d, "ids.npy"),
                                   allow_pickle=False)] \
        if header.get("has_ids") else None
    arrays = {}
    for fn in os.listdir(d):
        if fn.startswith("arr_") and fn.endswith(".npy"):
            arrays[fn[4:-4]] = arr(fn[:-4])
    meta = {}
    mp = os.path.join(d, "metadata.json")
    if os.path.exists(mp):
        with open(mp) as f:
            meta = json.load(f)
    return header, vectors, ids, arrays, meta


def index_exists(path: str) -> bool:
    """Whether a saved index exists at path (file, .npz or .idx)."""
    return (os.path.exists(path) or os.path.exists(path + ".npz")
            or _resolve_dir(path) is not None)


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        out[k] = v
    return out

"""ctypes bindings for the native corpus parser (``native/fast_corpus.cpp``).
Counterpart of ``hnsw_tpu/io/native.py``.

The library is built with g++ on first use into ``hnsw_tpu_torch/_build/``
under a name that carries the source's digest, written to a temporary file
and renamed into place, so concurrent processes never see a partial
library and ``native/`` is never written. When the toolchain or the schema
does not match, every entry point returns None and the loader falls back to
Python's json module. This is host parsing: no device and no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC_PATH = Path(__file__).resolve().parents[2] / "native" / "fast_corpus.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_lib = None
_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC_PATH.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfastcorpus_{digest}.so"


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                        str(SRC_PATH)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not SRC_PATH.exists():
            _failed = True
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.fc_parse.restype = ctypes.c_void_p
            lib.fc_parse.argtypes = [ctypes.c_char_p]
            for name in ("fc_count", "fc_dim", "fc_id_bytes", "fc_text_bytes"):
                getattr(lib, name).restype = ctypes.c_long
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.fc_fill.restype = None
            lib.fc_fill.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float)]
            for name in ("fc_ids", "fc_texts"):
                getattr(lib, name).restype = None
                getattr(lib, name).argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p]
            lib.fc_free.restype = None
            lib.fc_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError:
            _failed = True
        return _lib


def parse_corpus(path: str) -> Optional[Tuple[np.ndarray, list, list]]:
    """Parse a corpus JSON natively. Returns (embeddings f32[n, d], ids,
    texts) or None when the native path is unavailable or does not match."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.fc_parse(path.encode())
    if not h:
        return None
    try:
        n, d = lib.fc_count(h), lib.fc_dim(h)
        emb = np.empty((n, d), np.float32)
        lib.fc_fill(h, emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        ib = lib.fc_id_bytes(h)
        idbuf = ctypes.create_string_buffer(ib)
        lib.fc_ids(h, idbuf)
        ids = idbuf.raw[:ib].decode("utf-8", "replace").split("\n")
        tb = lib.fc_text_bytes(h)
        txbuf = ctypes.create_string_buffer(max(tb, 1))
        lib.fc_texts(h, txbuf)
        texts = txbuf.raw[:tb].decode("utf-8", "replace").split("\n") \
            if tb else [""] * n
        if len(ids) != n or len(texts) != n:
            return None
        return emb, ids, texts
    finally:
        lib.fc_free(h)

"""Build and load the hand-written Hopper kernels in ``hnsw_tpu_torch/csrc``.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under
``hnsw_tpu_torch/_build/``, at first use. The sources and the shared headers
(``csrc/*.cuh``) are hashed, so an edit rebuilds and an unchanged tree reuses
the library. All sources are compiled
at once, one ``nvcc`` process each. The libraries are loaded with ``ctypes``;
every pointer and the stream are passed as ``c_void_p``. Each C entry returns
``cudaGetLastError()`` after its launch, and ``check`` raises on a non-zero
code: a launch that the card refuses never runs, and nothing else reports it.

Nothing here runs at import: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("hop.cu", "scan.cu", "sweep.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int

# argument types of every C entry point, by library
SIGNATURES = {
    "hop.cu": {
        # pack, queries, sel, dots, csq, B, E, M0, D, N_pad, stream
        "hop_score_bf16": (P, P, P, P, P, I, I, I, I, I, P),
        # codes, queries, sel, dots, B, E, M0, D, N_pad, stream
        "hop_score_int8": (P, P, P, P, I, I, I, I, I, P),
    },
    "scan.cu": {
        # vectors, vkey, queries, part_d, part_r, B, N_pad, D, n, metric,
        # splits, stream
        "bucket_bank_bf16": (P, P, P, P, P, I, I, I, I, I, I, P),
        # v8, vkey, vscale, q8, qscale, part_d, part_r, B, N_pad, D, n,
        # metric, splits, stream
        "bucket_bank_int8": (P, P, P, P, P, P, P, I, I, I, I, I, I, P),
        # v8, nvkey, q8, part_d, part_r, B, N_pad, D, n, group, gbits,
        # splits, stream
        "packed_bank_int8": (P, P, P, P, P, I, I, I, I, I, I, I, P),
        # part_d, part_r, out_d, out_r, B, splits, stream
        "bucket_merge": (P, P, P, P, I, I, P),
    },
    "sweep.cu": {
        # vectors, v_sq, queries, part_d, part_r, B, N_pad, D, n, k, metric,
        # splits, stream
        "sweep_topk_bf16": (P, P, P, P, P, I, I, I, I, I, I, I, P),
        # v8, v_sq, vscale, q8, qmeta, part_d, part_r, B, N_pad, D, n, k,
        # metric, splits, stream
        "sweep_topk_int8": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
        # part_d, part_r, out_d, out_r, B, k, splits, stream
        "sweep_merge": (P, P, P, P, I, I, I, P),
    },
    "probes.cu": {
        # v (or vT), q, part, out, B, N, D, kmajor, splits, stream
        "colsum_bf16": (P, P, P, P, I, I, I, I, I, P),
        # v8, q8, out, B, N_used, D, nt, take_min, splits, stream
        "last_tile_int8": (P, P, P, I, I, I, I, I, I, P),
    },
}

# the last build's compiler output per source (ptxas register / spill
# report), for the smoke script to print
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def build_all() -> dict:
    """Compile every stale source in parallel; return {source: library}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    # wait for every compiler before reporting a failure, so none outlives
    # the call
    for src, (proc, _, _) in procs.items():
        BUILD_LOG[src], _ = proc.communicate()
    for src, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{src}:\n{BUILD_LOG[src]}")
        os.replace(tmp, out)
    return {src: _lib_path(src) for src in SOURCES}


@functools.lru_cache(maxsize=None)
def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = ctypes.CDLL(str(build_all()[src]))
    for name, argtypes in SIGNATURES[src].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def require(cond: bool, msg: str) -> None:
    """Validate what a kernel wrapper is given before it passes pointers."""
    if not cond:
        raise ValueError(msg)

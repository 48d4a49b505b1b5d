"""Build and load the hand-written Hopper kernels in ``hnsw_tpu_torch/csrc``.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under
``hnsw_tpu_torch/_build/``, at first use. The sources and the shared headers
(``csrc/*.cuh``: the Hopper mainloop ``wgmma.cuh`` of the three banks, the
sweeps and the floors) are hashed, so an edit rebuilds and an unchanged tree
reuses the library. ``wgmma.cuh`` needs no extra flag: ``sm_90a`` enables
``wgmma`` and ``setmaxnreg``, and the TMA tensor maps are encoded through
``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``. All sources are compiled
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
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("hop.cu", "scan.cu", "sweep.cu", "probes.cu", "descent.cu",
           "trace.cu", "expand.cu", "merge.cu", "gather.cu")
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
        # part_d, part_r, out_d, out_r, B, k, lists, stream
        "sweep_merge": (P, P, P, P, I, I, I, P),
    },
    "descent.cu": {
        # queries, q_sq, cur, cur_d, adj_upper, vectors, v_sq, cur_out,
        # d_out, B, L, N_pad, M, D, metric, stream
        "greedy_descent_bf16": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                P),
        "greedy_descent_f32": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                               P),
        # M, D, value bytes: the dynamic shared memory of a block, 0 where
        # the kernel cannot take that M
        "greedy_descent_shared_bytes": (I, I, I),
    },
    "probes.cu": {
        # v (or vT), q, part, out, B, N, D, kmajor, splits, stream
        "colsum_bf16": (P, P, P, P, I, I, I, I, I, P),
        # v8, q8, out, B, N_used, D, nt, take_min, splits, stream
        "last_tile_int8": (P, P, P, I, I, I, I, I, I, P),
    },
    "trace.cu": {
        # state, the phase the mark closes (< 0: none), stream
        "trace_stamp": (P, I, P),
    },
    "expand.cu": {
        # adj0, sel, beam, cand, valid, B, E, M0, ef, N_pad, stream
        "hop_expand": (P, P, P, P, P, I, I, I, I, I, P),
        # C, ef: the dynamic shared memory of a block, 0 where it does not
        # fit
        "hop_expand_shared_bytes": (I, I),
    },
    "merge.cu": {
        # beam_d, beam_ids, beam_exp, cand_d, cand_ids, active, out_d,
        # out_ids, out_exp, sel, out_active, B, ef, C, E, stream
        "hop_merge": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P),
        # ef, C: the dynamic shared memory of a block, 0 where it does not
        # fit
        "hop_merge_shared_bytes": (I, I),
    },
    "gather.cu": {
        # queries, q_sq, rows, rows64, vectors, v_sq, valid, out, B, C,
        # N_pad, D, metric, stream
        "hop_gather_score_f32": (P, P, P, I, P, P, P, P, I, I, I, I, I, P),
        "hop_gather_score_bf16": (P, P, P, I, P, P, P, P, I, I, I, I, I, P),
        # D, value bytes: the dynamic shared memory of a block, 0 where the
        # kernel cannot take that width
        "hop_gather_score_shared_bytes": (I, I),
    },
}

# the last build's compiler output per source (ptxas register / spill
# report), for the smoke script to print
BUILD_LOG: dict = {}


def kernel_resources(log: str) -> dict:
    """{mangled kernel name: (registers, spill bytes)} from the ptxas report
    (``-Xptxas -v``) in an nvcc log. Spill bytes are stores plus loads. For a
    kernel that calls setmaxnreg the registers are ptxas's count under its
    launch bounds, not what setmaxnreg gives a warpgroup."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


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
    """The current stream of `device` as an address: PyTorch's raw lookup,
    without the Stream object that torch.cuda.current_stream builds (about
    0.1 us against 3 us a call on the card's host)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def require(cond: bool, msg: str) -> None:
    """Validate what a kernel wrapper is given before it passes pointers."""
    if not cond:
        raise ValueError(msg)

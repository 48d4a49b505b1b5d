#!/usr/bin/env python3
"""Time the flat-scan and hop kernels of the hnsw_tpu_torch tree in the
current directory, at chip_smoke.py's shapes: 31,173 x 768 embedding-like
corpus (cosine), B = 4096, N_pad 31,744 (bf16) and 32,768 (int8), then the
matmul floors: the two int8 floors (matmul_only, matmul_min) at nt = 2048,
and the bf16 ones, mm_only at B = 4096 over the 31,744-row pack and
mm_only, its NT twin and mm_only_kmajor at B = 1024 over 32,768 rows; then
the hop kernels at the main path's hops (bench/kernels.py, HOP_SHAPES):
hop_score at (a) B = 1024, E = 4, M0 = 32, D = 768, (b) the same with E = 8
(hop_score_b) and (c) D = 128 over 500,000 blocks (hop_score_c), and
hop_score_int8 at (a). Every
scan kernel (the three banks bucket_topk, int8_bucket_topk and
int8_packed_topk, and both sweeps, exact_topk_sweep and int8_sweep_topk)
and every floor run the Hopper mainloop of csrc/wgmma.cuh; the hop kernels
their own kernels (csrc/hop.cu).
For the scan kernels and floors it prints the median of 30 CUDA-event
timings of each call (the host work before its launch included), then, on
a second line, each kernel's time in a run of 20 calls back to back (its
device time, where that is longer than the host work). For each hop kernel
it prints one JSON line of bench/kernels.py's hop_readings: those two times
on one (queries, sel) draw and cycling through 8 draws (the working set
then exceeds the 50 MB L2), the wrapper's host microseconds per call, the
bounds, and the ptxas registers and spill bytes of hop.cu's kernels. Kernel
names given as arguments are timed alone, in
that order (the card's state after one kernel can move the next one's
time).

To compare two trees on one card, unpack the other tree (for example the
parent commit: git archive HEAD hnsw_tpu_torch | tar -x -C <dir>) and run,
in one session, parent, change, change, parent:

    (cd <dir> && python3 <repo>/scripts/time_bank_kernels.py)
    python3 scripts/time_bank_kernels.py

The operands and calls come from this script's own tree
(hnsw_tpu_torch/bench/kernels.py, loaded by its path), the kernels from the
tree in the current directory, so a tree without that module is timed the
same way. Needs a CUDA card; each tree builds its own kernels.
"""

import importlib.util
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import hnsw_tpu_torch  # noqa: E402,F401  (sets TF32 off)
from hnsw_tpu_torch.io.datagen import generate_vectors  # noqa: E402

_HELPER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hnsw_tpu_torch", "bench", "kernels.py")


def _helper():
    spec = importlib.util.spec_from_file_location("_scan_operands", _HELPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("time_bank_kernels: no CUDA device", file=sys.stderr)
        return 1
    kernels = _helper()
    names = sys.argv[1:] or (SCAN_NAMES + list(HOPS))
    scans = [n for n in names if n not in HOPS]
    if scans:
        data = generate_vectors(31173, 768, distribution="embedding",
                                num_clusters=64, seed=42)
        x = kernels.probe_operands(data)
        calls = kernels.scan_calls(x)
        for label, call in kernels.floor_calls(x).items():
            calls[label.replace("_b4096_nt2048", "")] = call
        print(os.getcwd(), " ".join(
            f"{name}_ms {kernels.median_ms(calls[name], reps=30)}"
            for name in scans), flush=True)
        print(os.getcwd(), "back-to-back:", " ".join(
            f"{name}_ms {kernels.burst_ms(calls[name])}" for name in scans),
            flush=True)
        del x, calls
    for name in (n for n in names if n in HOPS):
        print(json.dumps(time_hop(kernels, name)), flush=True)
    return 0


SCAN_NAMES = ["bucket_topk", "exact_topk_sweep", "int8_bucket_topk",
              "int8_sweep_topk", "int8_packed_topk", "mm_only_b1024",
              "mm_only_nt_b1024", "mm_only_kmajor_b1024",
              "mm_only_b4096_n31744", "matmul_only", "matmul_min"]
# hop reading -> (kernel, shape of HOP_SHAPES)
HOPS = {"hop_score": ("hop_score", "a"), "hop_score_b": ("hop_score", "b"),
        "hop_score_c": ("hop_score", "c"),
        "hop_score_int8": ("hop_score_int8", "a")}
_PACKS = {}


def time_hop(kernels, name: str) -> dict:
    from hnsw_tpu_torch.ops import _cuda, hop
    kernel, shape_key = HOPS[name]
    shape = kernels.HOP_SHAPES[shape_key]
    int8 = kernel == "hop_score_int8"
    geometry = (shape["n_pad"], shape["m0"], shape["d"])
    x = kernels.hop_operands(shape=shape, pack=_PACKS.get(geometry),
                             codes=int8, rotations=kernels.HOP_ROTATIONS)
    # the pack of (a) serves (b)
    _PACKS.clear()
    _PACKS[geometry] = x["pack"]
    tensor = x["codes"] if int8 else x["pack"]
    fn = getattr(hop, kernel)
    out = dict(tree=os.getcwd(), reading=name, kernel=kernel,
               shape=shape_key, **shape)
    out.update(kernels.hop_readings(fn, tensor, x["draws"],
                                    outs=1 if int8 else 2))
    out["library_ms"] = kernels.median_ms(
        kernels.hop_library(tensor, x["queries"], x["sel"]), reps=5)
    out["hop_cu_ptxas"] = _cuda.kernel_resources(
        _cuda.BUILD_LOG.get("hop.cu", ""))
    return out


if __name__ == "__main__":
    sys.exit(main())

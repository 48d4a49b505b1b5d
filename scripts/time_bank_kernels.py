#!/usr/bin/env python3
"""Time the flat-scan kernels of the hnsw_tpu_torch tree in the current
directory, at chip_smoke.py's shapes: 31,173 x 768 embedding-like corpus
(cosine), B = 4096, N_pad 31,744 (bf16) and 32,768 (int8). The two
bucketed bank kernels (bucket_topk, int8_bucket_topk) keep their own tile
loop; the three others (exact_topk_sweep, int8_sweep_topk, int8_packed_topk)
run the shared one of csrc/tile.cuh. Prints the median of 30 CUDA-event
timings of each.

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
    data = generate_vectors(31173, 768, distribution="embedding",
                            num_clusters=64, seed=42)
    calls = kernels.scan_calls(kernels.probe_operands(data))
    print(os.getcwd(), " ".join(
        f"{name}_ms {kernels.median_ms(fn, reps=30)}"
        for name, fn in calls.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

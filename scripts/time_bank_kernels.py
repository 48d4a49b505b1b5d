#!/usr/bin/env python3
"""Time the two bucketed bank kernels (bucket_topk, int8_bucket_topk) of the
hnsw_tpu_torch tree in the current directory, at chip_smoke.py's shapes:
31,173 x 768 embedding-like corpus (cosine), B = 4096, N_pad 31,744 (bf16)
and 32,768 (int8). Prints the median of 30 CUDA-event timings of each.

To compare two trees on one card, unpack the other tree (for example the
parent commit: git archive HEAD hnsw_tpu_torch | tar -x -C <dir>) and run,
in one session, parent, change, change, parent:

    (cd <dir> && python3 <repo>/scripts/time_bank_kernels.py)
    python3 scripts/time_bank_kernels.py

Needs a CUDA card; each tree builds its own kernels.
"""

import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import hnsw_tpu_torch  # noqa: E402,F401  (sets TF32 off)
from hnsw_tpu_torch.io.datagen import generate_vectors  # noqa: E402
from hnsw_tpu_torch.models.flat import quantize_rows  # noqa: E402
from hnsw_tpu_torch.ops import scan  # noqa: E402
from hnsw_tpu_torch.types import Corpus  # noqa: E402


def median_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_bank_kernels: no CUDA device", file=sys.stderr)
        return 1
    data = generate_vectors(31173, 768, distribution="embedding",
                            num_clusters=64, seed=42)
    c = Corpus.from_array(data)
    pad = torch.nn.functional.pad
    vec = pad(c.vectors.to(torch.bfloat16), (0, 0, 0, 31744 - c.n_pad))
    vkey = scan.bf16_vkey(pad(c.sq_norms, (0, 31744 - c.n_pad)), "cosine")
    q = c.pad_queries(data[:4096]).to(torch.bfloat16)
    v8, vs = quantize_rows(c.vectors)
    v8 = pad(v8, (0, 0, 0, 32768 - c.n_pad))
    vs = pad(vs, (0, 32768 - c.n_pad))
    vk8 = scan.int8_vkey(vs, pad(c.sq_norms, (0, 32768 - c.n_pad)), "cosine")
    q8, qs = quantize_rows(c.pad_queries(data[:4096]))
    bf16 = median_ms(lambda: scan.bucket_bank(vec, vkey, q, c.n,
                                              metric="cosine"))
    int8 = median_ms(lambda: scan.int8_bucket_bank(v8, vk8, vs, q8, qs, c.n,
                                                   metric="cosine"))
    print(os.getcwd(), "bucket_bank_ms", bf16, "int8_bucket_bank_ms", int8,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

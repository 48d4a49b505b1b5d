#!/usr/bin/env python3
"""Timed ablations of the int8 hop kernel (hop_score_int8, csrc/hop.cu) on
the CUDA card, at chip_smoke.py's shape (hnsw_tpu_torch/bench/kernels.py,
HOP_SHAPE): B = 1024 queries, E = 4 selected blocks of M0 = 32 rows,
D = 768, a pack of 31,176 blocks.

    python3 scripts/hop_int8_ablate.py

Each variant is csrc/hop.cu with one piece of its design changed, built by
nvcc into hnsw_tpu_torch/_build/ablate/ (all at once) and called through its
C entry: the kernel as it stands; rows a warp scores at once (kI8Rows) 1, 2
and 8 instead of 4; and each byte converted by I2F
((float)(int8_t)byte) instead of the byte_perm conversion. Prints one JSON
line per variant: ptxas registers and spill bytes, the largest difference
from hop_score_int8_plain, the median of 30 CUDA-event timings of one call
and the time of one call in a run of 20 back to back (bench/kernels.py,
burst_ms: the device time, where the host work of a call is shorter). The
package's own wrapper and the bf16 kernel (hop_score, on a bf16 pack of the
same shape) are timed beside them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 42

ROWS = "constexpr int kI8Rows = 4;"
CONVERT = ("__fsub_rn(__int_as_float(__byte_perm(w[h], 0x4B000000u, "
           "0x7650 + j)),\n                                      8388736.f)")
I2F = "(float)(int8_t)(((h ? raw.y : raw.x) >> (8 * j)) & 0xff)"
VARIANTS = {
    "as_is": [],
    "rows_1": [(ROWS, "constexpr int kI8Rows = 1;")],
    "rows_2": [(ROWS, "constexpr int kI8Rows = 2;")],
    "rows_8": [(ROWS, "constexpr int kI8Rows = 8;")],
    "i2f": [(CONVERT, I2F)],
}


def build(variants: dict) -> dict:
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "hop.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the piece to replace is not in hop.cu")
            text = text.replace(old, new)
        cu = out_dir / f"hop_{name}.cu"
        # the headers hop.cu includes are the toolkit's own
        cu.write_text(text)
        lib = out_dir / f"libhop_{name}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        res = [v for k, v in _cuda.kernel_resources(log).items()
               if "15hop_int8_kernelILb0E" in k]
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.hop_score_int8
        fn.argtypes = list(_cuda.SIGNATURES["hop.cu"]["hop_score_int8"])
        fn.restype = ctypes.c_int
        libs[name] = (fn, res[0] if res else (None, None))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hop_int8_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401
    from hnsw_tpu_torch.bench.kernels import (HOP_SHAPE, burst_ms, hop_operands,
                                              median_ms)
    from hnsw_tpu_torch.ops import _cuda, hop

    dev = torch.device("cuda")
    x = hop_operands(SEED)
    queries, sel, codes = x["queries"], x["sel"], x["codes"]
    want = hop.hop_score_int8_plain(codes, queries, sel)
    tol = 1e-4 * float(want.abs().max())
    stream = _cuda.stream_ptr(dev)
    b, e, m0, d, n_pad = (HOP_SHAPE[k] for k in ("b", "e", "m0", "d", "n_pad"))
    libs = build(VARIANTS)
    for name, (fn, (regs, spill)) in libs.items():
        out = torch.empty((b, e * m0), dtype=torch.float32, device=dev)

        def call():
            _cuda.check(fn(codes.data_ptr(), queries.data_ptr(),
                           sel.data_ptr(), out.data_ptr(), b, e, m0, d, n_pad,
                           stream), name)
        call()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        print(json.dumps({"variant": name, "registers": regs,
                          "spill_bytes": spill, "max_abs_err": err,
                          "tol": tol, "ms": median_ms(call, reps=30),
                          "back_to_back_ms": burst_ms(call)}), flush=True)
        if err > tol:
            print(f"{name} disagrees with the plain version", file=sys.stderr)
            return 1
    for name, call in (
            ("hop_score_int8 (the package's wrapper)",
             lambda: hop.hop_score_int8(codes, queries, sel)),
            ("hop_score (bf16 pack)",
             lambda: hop.hop_score(x["pack"], queries, sel))):
        print(json.dumps({"variant": name, "ms": median_ms(call, reps=30),
                          "back_to_back_ms": burst_ms(call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

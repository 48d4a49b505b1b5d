#!/usr/bin/env python3
"""Timed ablations of the packed int8 bank (int8_packed_topk,
csrc/scan.cu:packed_bank_wgmma_kernel) on the CUDA card, at chip_smoke.py's
shape (hnsw_tpu_torch/bench/kernels.py): B = 4096 queries of a 31,173 x 768
embedding-like corpus, cosine, over the 32,768-row int8 pack at nt = 2048
(2 corpus splits of 8 nt-row tiles on 132 SMs).

    python3 scripts/packed_ablate.py [variant ...]

Each variant is csrc/scan.cu with one piece of the packed kernel changed,
built by nvcc into hnsw_tpu_torch/_build/ablate/ (all at once) and called
through its C entries, the kernel and then bucket_merge:
  as_is      the kernel as it stands;
  no_fold    (timing only: wrong rows) the split's bank is folded once, at
             its last nt-row tile, not at every one: the insert and key
             formation stay, the other folds into the bank in shared memory
             go;
  no_insert  (timing only) the key is formed and xor-ed into one register
             in place of the three-instruction insert; the folds stay;
  loop_only  (timing only) each accumulator xor-ed into one register, no
             key, no insert, one fold a split: the product loop and the
             accumulator reads;
  plain_ptrs the bank through plain (not volatile) pointers, which lets
             ptxas hoist a fold's shared loads;
  tile_regs  the bank's nt-row tile indices in registers, its keys alone in
             shared memory (64 KB, not 96), so the int8 ring gets 7 stages,
             not 5.
It also times the matmul_only floor (csrc/probes.cu, the same loop with a
store of the last tile) on the same operands, so that a variant's time less
the floor's is what its epilogue costs.
Prints one JSON line per variant: ptxas registers and spill bytes, how many
of ptxas's C7514 / C7518 notes (wgmma serialized) the build of the whole
source printed (the other kernels of scan.cu print none), the
largest key difference and the row agreement with the plain version (the
variants that keep the answer), the median of 30 CUDA-event timings of one call and the time of one
call in a run of 20 back to back (bench/kernels.py, burst_ms).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INSERT = """p2[i] = min(p2[i], max(p1[i], p));
                        p1[i] = min(p1[i], p);"""
FOLD = "if (gi == group - 1) fold();"
FOLD_ONCE = "if (tile == t_end - 1) fold();"
BANK_T = """volatile uint32_t* const bank_t =
            reinterpret_cast<volatile uint32_t*>(bank2 + kBankWords);"""
VARIANTS = {
    "as_is": [],
    "no_fold": [(FOLD, FOLD_ONCE)],
    "no_insert": [(INSERT, "p1[i] ^= p;")],
    "loop_only": [(INSERT, "p1[i] ^= acc[i];"), (FOLD, FOLD_ONCE)],
    "plain_ptrs": [
        ("volatile int* const bank1 = reinterpret_cast<volatile int*>(",
         "int* const bank1 = reinterpret_cast<int*>("),
        ("volatile int* const bank2", "int* const bank2"),
        (BANK_T, BANK_T.replace("volatile ", ""))],
    "tile_regs": [
        (BANK_T, "uint32_t bank_t[wg::kAcc];"),
        ("bank_t[i * kConsumerThreads] = 0;", "bank_t[i] = 0;"),
        ("const uint32_t at = bank_t[i * kConsumerThreads];",
         "const uint32_t at = bank_t[i];"),
        ("bank_t[i * kConsumerThreads] = (a_first", "bank_t[i] = (a_first"),
        ("const uint32_t at = bank_t[s];", "const uint32_t at = bank_t[i + e];"),
        ("wg::plan(D, 3 * kBankWords * 4)", "wg::plan(D, 2 * kBankWords * 4)")],
}
KEEPS_ANSWER = {"as_is", "plain_ptrs", "tile_regs"}
KERNEL = "24packed_bank_wgmma_kernel"


def build(variants: dict) -> dict:
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "scan.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the piece to replace is not in scan.cu")
            text = text.replace(old, new)
        # beside the sources, so that #include "wgmma.cuh" finds the header
        cu = _cuda.CSRC / f"_ablate_scan_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libscan_{name}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib, cu)
    libs = {}
    for name, (proc, lib, cu) in procs.items():
        log, _ = proc.communicate()
        cu.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn_name, argtypes in _cuda.SIGNATURES["scan.cu"].items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        (regs, spill), = [v for k, v in _cuda.kernel_resources(log).items()
                          if KERNEL in k]
        serialized = len(re.findall(r"\(C751[48]\)", log))
        libs[name] = (cdll, dict(registers=regs, spill_bytes=spill,
                                 serialized_notes=serialized))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("packed_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)
    from hnsw_tpu_torch.bench.kernels import (burst_ms, floor_calls,
                                              median_ms, probe_operands)
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.ops import _cuda, scan

    dev = torch.device("cuda")
    names = sys.argv[1:] or list(VARIANTS)
    data = generate_vectors(31173, 768, distribution="embedding",
                            num_clusters=64, seed=42)
    x = probe_operands(data)
    n, v8, nvkey, q8 = x["n"], x["v8"], x["nvk8"], x["q8"]
    b, (n_pad, d) = q8.shape[0], v8.shape
    nt = scan.INT8_NT
    group, gbits = scan._group_bits(nt)
    splits = scan._splits(-(-b // 64), n_pad // nt, dev)
    want_d, want_r = scan.int8_packed_bank_plain(v8, nvkey, q8, n, nt=nt)
    stream = _cuda.stream_ptr(dev)
    part_d = torch.empty((splits, b, 256), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, b, 256), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, 256), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, 256), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (v8, nvkey, q8, part_d, part_r)]

    floor = floor_calls(x)["matmul_only_b4096_nt2048"]
    print(json.dumps({"variant": "floor", "kernel": "matmul_only",
                      "ms": median_ms(floor, reps=30),
                      "back_to_back_ms": burst_ms(floor)}), flush=True)
    libs = build({name: VARIANTS[name] for name in names})
    for name, (lib, fields) in libs.items():
        def call():
            _cuda.check(lib.packed_bank_int8(*ptrs, b, n_pad, d, n, group,
                                             gbits, splits, stream), name)
            _cuda.check(lib.bucket_merge(
                part_d.data_ptr(), part_r.data_ptr(), out_d.data_ptr(),
                out_r.data_ptr(), b, splits, stream), "bucket_merge")
        call()
        torch.cuda.synchronize()
        rec = {"variant": name, "kernel": "int8_packed_topk", **fields,
               "splits": splits}
        if name in KEEPS_ANSWER:
            live = want_d < 1e29
            rec["live_entries_agree"] = bool(torch.equal(out_d < 1e29, live))
            rec["max_abs_err"] = float((out_d - want_d)[live].abs().max())
            rec["row_agreement"] = float((out_r == want_r)[live].float().mean())
        rec["ms"] = median_ms(call, reps=30)
        rec["back_to_back_ms"] = burst_ms(call)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Timed ablations of the two sweep kernels (exact_topk_sweep and
int8_sweep_topk, csrc/sweep.cu) on the CUDA card, at chip_smoke.py's shapes
(hnsw_tpu_torch/bench/kernels.py): B = 4096 queries of a 31,173 x 768
embedding-like corpus, cosine, bf16 over the 31,744-row pack at k = 10 and
int8 over the 32,768-row pack at k = 16.

    python3 scripts/sweep_ablate.py [variant ...]

Each variant is csrc/sweep.cu with one piece of its design changed, built by
nvcc into hnsw_tpu_torch/_build/ablate/ (all at once) and called through its
C entries, the kernel and then sweep_merge:
  as_is      the kernel as it stands;
  exact      no cheap test: every element takes the exact distance;
  no_insert  (timing only: wrong lists) the rounds of exact distances, but
             no insert, so the thresholds never tighten;
  no_share   each consumer gates its elements by its own lists' k-th
             entries only, not by the better of its and the other's;
  no_seed    a consumer's first tile goes through the cheap pass and the
             rounds like every other, instead of building its lists in bulk;
  no_select  (timing only) no rounds: nothing reads the per-element tests,
             the compiler drops them, and what is left is the product loop;
  cheap_only (timing only) the per-element tests, read by a test that
             never holds, and no rounds: the product loop and the cheap
             pass;
  counts     the kernel as it stands with counters (atomics on a global of
             the variant's library, read through a C entry the variant
             adds): per consumer warp and tile, rounds of exact distances,
             candidates that beat their gate, inserts, and clock64 cycles
             spent waiting for the other consumer, on the tile's products
             (of which waiting for the ring's data) and on its epilogue.
Prints one JSON line per variant and kernel: ptxas registers and spill bytes
(the largest over the three metrics' instantiations of that type), how many
of ptxas's C7514 / C7518 notes (wgmma serialized) the build printed, the
largest distance difference and the row agreement with the plain version
(for the variants that keep the answer), the median of 30 CUDA-event timings
of one call and the time of one call in a run of 20 back to back
(bench/kernels.py, burst_ms).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FILTER = "constexpr bool kFilter = true;"
TILE = "const unsigned live = live_bits(lim);"  # once a tile
ROUNDS = "while (__any_sync(FULL, mb != 0u)) {"
CANDS = "for (unsigned m = cand; m != 0u; m &= m - 1u) {"
INSERT = "const float up_d = __shfl_up_sync(FULL, ldg, 1);"
SHARE = "if (before(od, orow, wd[H], wr[H])) { wd[H] = od; wr[H] = orow; }"
SEED = "if (tile == t_begin + w) {"
SYNC = "if (t > t_begin) named_sync(1 + w);"
DRAIN = "wg::wgmma_wait<0>();\n        wg::fence_acc(lo);"
EPI = "epilogue(lo, hi, t);"
FULL_WAIT = "wg::mbar_wait(r.full + 8 * stage, (g / r.stages) & 1);"
VARIANTS = {
    "as_is": [],
    "exact": [(FILTER, "constexpr bool kFilter = false;")],
    "no_insert": [(CANDS, "for (unsigned m = 0u; m != 0u; m &= m - 1u) {")],
    "no_select": [(ROUNDS, "while (false) {")],
    "cheap_only": [(ROUNDS, "if (__any_sync(FULL, mb == 0x9E3779B9u)) {")],
    "no_share": [(SHARE, "")],
    "no_seed": [(SEED, "if (false) {")],
    "counts": [
        ("#include \"wgmma.cuh\"\n",
         "#include \"wgmma.cuh\"\n__device__ unsigned long long g_count[8];\n"),
        (TILE, TILE + " if (lane == 0) atomicAdd(&g_count[0], 1ull);"),
        (ROUNDS, ROUNDS + " if (lane == 0) atomicAdd(&g_count[1], 1ull);"),
        (CANDS, "if (lane == 0) atomicAdd(&g_count[2], (unsigned long long)__popc(cand));"
         + CANDS),
        (INSERT, "if (lane == 0) atomicAdd(&g_count[3], 1ull);" + INSERT),
        # cycles (clock64, summed over consumer warps): waiting for the
        # other consumer, the tile's products, the tile's epilogue
        (SYNC, "long long c0 = clock64(); " + SYNC + " const long long c1 = clock64();"
         " if ((threadIdx.x & 31) == 0) atomicAdd(&g_count[4], (unsigned long long)(c1 - c0));"),
        (DRAIN, DRAIN + " if ((threadIdx.x & 31) == 0) atomicAdd(&g_count[5], "
         "(unsigned long long)(clock64() - c1));"),
        (EPI, "{ const long long c2 = clock64(); " + EPI + " if ((threadIdx.x & 31) == 0) "
         "atomicAdd(&g_count[6], (unsigned long long)(clock64() - c2)); }"),
        (FULL_WAIT, "{ const long long c3 = clock64(); " + FULL_WAIT + " if ((threadIdx.x & "
         "31) == 0) atomicAdd(&g_count[7], (unsigned long long)(clock64() - c3)); }"),
    ],
}
KEEPS_ANSWER = {"as_is", "exact", "counts", "no_share", "no_seed"}
COUNT_ENTRY = """
extern "C" int sweep_counts(unsigned long long* out) {
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_count, sizeof(g_count));
    static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_count, zero, sizeof(zero));
    return (int)err;
}
"""


def build(variants: dict) -> dict:
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "sweep.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the piece to replace is not in sweep.cu")
            text = text.replace(old, new)
        if name == "counts":
            text += COUNT_ENTRY
        # beside the sources, so that #include "wgmma.cuh" finds the header
        cu = _cuda.CSRC / f"_ablate_sweep_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libsweep_{name}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib, cu)
    libs = {}
    for name, (proc, lib, cu) in procs.items():
        log, _ = proc.communicate()
        cu.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        res = _cuda.kernel_resources(log)
        cdll = ctypes.CDLL(str(lib))
        if name == "counts":
            cdll.sweep_counts.argtypes = [ctypes.c_void_p]
            cdll.sweep_counts.restype = ctypes.c_int
        for fn_name, argtypes in _cuda.SIGNATURES["sweep.cu"].items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        fields = {}
        for int8 in (False, True):
            found = [v for k, v in res.items()
                     if f"18sweep_wgmma_kernelILb{int(int8)}E" in k]
            fields[int8] = dict(registers=max(r for r, _ in found),
                                spill_bytes=max(s for _, s in found))
        serialized = len(re.findall(r"\(C751[48]\)", log))
        libs[name] = (cdll, fields, serialized)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)
    from hnsw_tpu_torch.bench.kernels import burst_ms, median_ms, probe_operands
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.ops import _cuda, scan

    dev = torch.device("cuda")
    names = sys.argv[1:] or list(VARIANTS)
    data = generate_vectors(31173, 768, distribution="embedding",
                            num_clusters=64, seed=42)
    x = probe_operands(data)
    n, b = x["n"], 4096
    stream = _cuda.stream_ptr(dev)
    cases = {
        False: dict(k=10, args=(x["v31744"], x["vsq31744"], x["q4096"]),
                    plain=lambda: scan.exact_topk_sweep_plain(
                        x["v31744"], x["vsq31744"], x["q4096"], n, k=10,
                        metric="cosine")),
        True: dict(k=16, args=(x["v8"], x["vsq"], x["vs"], x["q8"], x["qmeta"]),
                   plain=lambda: scan.int8_sweep_topk_plain(
                       x["v8"], x["vs"], x["vsq"], x["q8"], x["qmeta"], n,
                       k=16, metric="cosine", nt=1024)),
    }
    want = {}
    for int8, case in cases.items():
        want[int8] = case["plain"]()
    libs = build({name: VARIANTS[name] for name in names})
    for name, (lib, fields, serialized) in libs.items():
        for int8, case in cases.items():
            k, args = case["k"], case["args"]
            n_pad, d = args[0].shape
            splits, lists = scan.sweep_plan(-(-b // 64), n_pad // 128,
                                            scan._sms(dev))
            part_d = torch.empty((lists, b, k), dtype=torch.float32, device=dev)
            part_r = torch.empty((lists, b, k), dtype=torch.int32, device=dev)
            out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
            out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
            ptrs = [t.data_ptr() for t in args]
            kernel = lib.sweep_topk_int8 if int8 else lib.sweep_topk_bf16

            def call():
                _cuda.check(kernel(*ptrs, part_d.data_ptr(), part_r.data_ptr(),
                                   b, n_pad, d, n, k, 0, splits, stream), name)
                _cuda.check(lib.sweep_merge(
                    part_d.data_ptr(), part_r.data_ptr(), out_d.data_ptr(),
                    out_r.data_ptr(), b, k, lists, stream), "sweep_merge")
            call()
            torch.cuda.synchronize()
            rec = {"variant": name, "kernel": "int8_sweep_topk" if int8
                   else "exact_topk_sweep", **fields[int8],
                   "serialized_notes": serialized}
            if name in KEEPS_ANSWER:
                pd, pr = want[int8]
                rec["max_abs_err"] = float((out_d - pd).abs().max())
                rec["row_agreement"] = float((out_r == pr).float().mean())
            if name == "counts":
                counts = (ctypes.c_ulonglong * 8)()
                lib.sweep_counts(counts)     # clear
                call()
                _cuda.check(lib.sweep_counts(counts), "sweep_counts")
                warp_tiles = counts[0]
                rec.update(warp_tiles=warp_tiles,
                           rounds_per_warp_tile=counts[1] / warp_tiles,
                           candidates_per_warp_tile=counts[2] / warp_tiles,
                           inserts_per_warp_tile=counts[3] / warp_tiles,
                           wait_cycles_per_warp_tile=counts[4] / warp_tiles,
                           product_cycles_per_warp_tile=counts[5] / warp_tiles,
                           epilogue_cycles_per_warp_tile=counts[6] / warp_tiles,
                           data_wait_cycles_per_warp_tile=counts[7] / warp_tiles)
            rec["ms"] = median_ms(call, reps=30)
            rec["back_to_back_ms"] = burst_ms(call)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

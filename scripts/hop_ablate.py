#!/usr/bin/env python3
"""Timed ablations of the bf16 hop kernel (hop_score, csrc/hop.cu) on the
CUDA card, at the main path's three hops (hnsw_tpu_torch/bench/kernels.py,
HOP_SHAPES): (a) B = 1024, E = 4, M0 = 32, D = 768 over 31,176 blocks, (b)
the same with E = 8, (c) E = 4, D = 128 over 500,000 blocks.

    python3 scripts/hop_ablate.py [variant[+variant...] ...]

Each variant is csrc/hop.cu with one piece of its design changed, built by
nvcc into hnsw_tpu_torch/_build/ablate/ (all at once) and called through its
C entry hop_score_bf16: the kernel as it stands; a stage of 6 KiB (4 rows
at D = 768) or 24 KiB (16 rows, 8 stages: the same ring); a ring of 8
stages; two blocks per SM (8 stages each); 16 consumer warps; 4 warp-steps
scored at once (kSteps; 16 at D = 128 and 8 otherwise as it stands); each
stage moved as bulk copies of 2 KiB (copies_2k); the stage freed right
after its loads instead of after its products (release_early); and `old`, the kernel the ring
replaced (one block of 256 threads per query, each warp loading one row at
a time with 16-byte loads, the query staged in shared memory), restored
beside it; and two cuts that time one side of the ring alone, their
results wrong by design: `copy_only` (the consumers wait for each stage and
release it, with no work) and `compute_only` (the producer arrives on each
full barrier with no copy, the consumers score whatever the stage holds).
Variants joined by "+" apply together. Prints one JSON line per variant: ptxas registers and spill
bytes, and at each shape the largest difference from hop_score_plain and
bench/kernels.py's hop_readings on 8 rotated (queries, sel) draws (one call,
20 back to back, each also cycling through the draws; the host
microseconds of one call include this script's allocation of the outputs).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 42

STAGE = "constexpr int kStageBytes = 12288;"
STAGES = "constexpr int kStages = 16;"
PER_SM = "constexpr int kBlocksPerSM = 1;"
WARPS = "constexpr int kConsumerWarps = 8;"
PLAN = "    const RingPlan plan = ring_plan(M0, D);\n"
COPY = """                        mbar_expect_tx(full0 + 8 * slot, piece);
                        bulk_load(ring0 + slot * kStageBytes, src + (long long)p * kStageBytes,
                                  piece, full0 + 8 * slot);
"""
WAIT = "        mbar_wait(full0 + 8 * slot, (i / kStages) & 1);\n"
INNER = "                // the steps innermost: 2 * kSteps independent FMA chains\n"
LATE = "            if ((s0 + kSteps) * R >= nr) {\n"
KSTEPS = "constexpr int kSteps = NC == 1 ? 16 : 8;"
NAMESPACE_END = "}  // namespace\n"

# the bf16 kernel of csrc/hop.cu before the ring
OLD_KERNEL = r'''
__device__ __forceinline__ void load_query(const float* __restrict__ q, float* qs, int D,
                                           int per_chunk) {
    const int chunks = D / per_chunk;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
        qs[(d % per_chunk) * chunks + d / per_chunk] =
            __bfloat162float(__float2bfloat16_rn(q[d]));
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hop_bf16_kernel(const __nv_bfloat16* __restrict__ pack, const float* __restrict__ queries,
                const int* __restrict__ sel, float* __restrict__ dots, float* __restrict__ csq,
                int E, int M0, int D, int N_pad) {
    extern __shared__ float qs[];
    const int b = blockIdx.x;
    load_query(queries + (long long)b * D, qs, D, 8);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int C = E * M0;
    const int chunks = D >> 3;
    for (int r = warp; r < C; r += kWarps) {
        const int e = r / M0, m = r - e * M0;
        const long long row = clamp_row(sel[(long long)b * E + e], N_pad);
        const uint4* src = reinterpret_cast<const uint4*>(pack + (row * M0 + m) * (long long)D);
        float acc = 0.f, sq = 0.f;
        for (int c = lane; c < chunks; c += 32) {
            const uint4 raw = __ldg(src + c);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 v = __bfloat1622float2(h[j]);
                acc = fmaf(qs[(2 * j) * chunks + c], v.x, acc);
                acc = fmaf(qs[(2 * j + 1) * chunks + c], v.y, acc);
                sq = fmaf(v.x, v.x, sq);
                sq = fmaf(v.y, v.y, sq);
            }
        }
        acc = warp_sum(acc);
        sq = warp_sum(sq);
        if (lane == 0) {
            dots[(long long)b * C + r] = acc;
            csq[(long long)b * C + r] = sq;
        }
    }
}

'''
OLD_LAUNCH = r'''    hop_bf16_kernel<<<B, kThreads, D * sizeof(float), st>>>(
        (const __nv_bfloat16*)pack, (const float*)queries, (const int*)sel,
        (float*)dots, (float*)csq, E, M0, D, N_pad);
    return (int)cudaGetLastError();
'''

VARIANTS = {
    "as_is": [],
    "stage_6k": [(STAGE, "constexpr int kStageBytes = 6144;")],
    "stage_24k": [(STAGE, "constexpr int kStageBytes = 24576;"),
                  (STAGES, "constexpr int kStages = 8;")],
    "stages_8": [(STAGES, "constexpr int kStages = 8;")],
    "two_per_sm": [(PER_SM, "constexpr int kBlocksPerSM = 2;"),
                   (STAGES, "constexpr int kStages = 8;")],
    "warps_16": [(WARPS, "constexpr int kConsumerWarps = 16;")],
    "steps_4": [(KSTEPS, "constexpr int kSteps = 4;")],
    "copies_2k": [(COPY, """                        mbar_expect_tx(full0 + 8 * slot, piece);
                        for (int o = 0; o < piece; o += 2048)
                            bulk_load(ring0 + slot * kStageBytes + o,
                                      src + (long long)p * kStageBytes + o,
                                      min(2048, piece - o), full0 + 8 * slot);
""")],
    "release_early": [
        (LATE, "            if (NC == 0 && (s0 + kSteps) * R >= nr) {\n"),
        (INNER, """                if ((s0 + kSteps) * R >= nr) {
                    __syncwarp();
                    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
                }
""" + INNER)],
    "old": [(NAMESPACE_END, OLD_KERNEL + NAMESPACE_END),
            (PLAN, OLD_LAUNCH + PLAN)],
    # timing only: the ring with no consumer work (the copies alone), and
    # the consumers on stages that no copy fills (their work alone)
    "copy_only": [(WAIT, WAIT + "        __syncwarp();\n"
                   "        if (lane == 0) mbar_arrive(empty0 + 8 * slot);\n"
                   "        continue;\n")],
    "compute_only": [(COPY, "                        mbar_arrive(full0 + 8 * slot);\n")],
}
TIMING_ONLY = ("copy_only", "compute_only")


def build(variants: dict) -> dict:
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "hop.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the piece to replace is not in hop.cu once")
            text = text.replace(old, new)
        cu = out_dir / f"hopbf16_{name.replace('+', '_and_')}.cu"
        # the headers hop.cu includes are the toolkit's own
        cu.write_text(text)
        lib = out_dir / f"libhopbf16_{name.replace('+', '_and_')}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        res = {k: v for k, v in _cuda.kernel_resources(log).items()
               if "hop_bf16" in k}
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.hop_score_bf16
        fn.argtypes = list(_cuda.SIGNATURES["hop.cu"]["hop_score_bf16"])
        fn.restype = ctypes.c_int
        libs[name] = (fn, res)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hop_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401
    from hnsw_tpu_torch.bench.kernels import (HOP_ROTATIONS, HOP_SHAPES,
                                              hop_operands, hop_readings)
    from hnsw_tpu_torch.ops import _cuda, hop

    names = sys.argv[1:] or list(VARIANTS)
    libs = build({n: [e for part in n.split("+") for e in VARIANTS[part]]
                  for n in names})
    dev = torch.device("cuda")
    stream = _cuda.stream_ptr(dev)
    rows = {name: {"variant": name, "ptxas": res}
            for name, (_, res) in libs.items()}
    pack = None
    for key, shape in HOP_SHAPES.items():
        if pack is not None and pack.shape != (
                shape["n_pad"], shape["m0"], shape["d"]):
            pack = None
            torch.cuda.empty_cache()
        x = hop_operands(SEED, shape=shape, pack=pack, codes=False,
                         rotations=HOP_ROTATIONS)
        pack = x["pack"]
        want = hop.hop_score_plain(pack, x["queries"], x["sel"])
        for name, (fn, _) in libs.items():
            def call(p, q, s, fn=fn, name=name):
                out = torch.empty((2, s.shape[0], s.shape[1] * p.shape[1]),
                                  dtype=torch.float32, device=dev)
                _cuda.check(fn(p.data_ptr(), q.data_ptr(), s.data_ptr(),
                               out[0].data_ptr(), out[1].data_ptr(),
                               s.shape[0], s.shape[1], p.shape[1], p.shape[2],
                               p.shape[0], stream), name)
                return out
            got = call(pack, x["queries"], x["sel"])
            torch.cuda.synchronize()
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            ok = all(err <= 1e-4 * float(w.abs().max())
                     for err, w in zip(errs, want))
            rows[name][key] = dict(max_abs_err=max(errs), agrees=ok,
                                   **hop_readings(call, pack, x["draws"], 2))
            if not ok and not set(name.split("+")) & set(TIMING_ONLY):
                print(json.dumps(rows[name]), flush=True)
                print(f"{name} disagrees with the plain version at ({key})",
                      file=sys.stderr)
                return 1
        del x, want
    for name in names:
        print(json.dumps(rows[name]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

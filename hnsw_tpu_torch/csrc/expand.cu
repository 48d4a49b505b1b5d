// The expand phase of the HNSW hop body: adjacency gather, dedupe and
// in-beam test, one block a query.
//
// Hand-written, with no pallas_call counterpart: it replaces the XLA ops of
// the reference's hop body (hnsw_tpu/models/hnsw/search.py, the gather of
// adj0[sel_ids], _dedupe_row and the in-beam `any`), which the port ran as
// about fifteen broadcast PyTorch operators a body: a [B, C, C] and a
// [B, C, ef] bool temporary written and read back (about 160 MB a body at
// B = 1,024, C = 128, ef = 200) and a launch each.
//
// Contract. For query b and slot s = e * M0 + m (the order of the body's
// nb.reshape(B, C), C = E * M0), let id = adj0[sel[b, e], m] where
// sel[b, e] >= 0, else -1. Then
//   valid[b, s] = id >= 0, and no slot j < s of the row holds id, and no
//                 beam[b, t] (t < ef) equals id;
//   cand[b, s]  = id where valid, else -1.
// A row sel[b, e] >= N_pad reads row N_pad - 1, so that no input reads
// outside adj0. Integer logic only: the results are the plain version's bit
// for bit.
//
// Bound on the H100: launch latency, then bytes. The work reads sel (16 KB),
// the selected adjacency rows (512 KB, from an adj0 that L2 holds) and the
// beam (800 KB), and writes 0.65 MB at B = 1,024: about 2 MB, 0.6 us at
// 3.35 TB/s; its B x C x (C / 2 + ef) integer compares (about 35 M) are
// about a microsecond of the card. So a launch inside the captured graph,
// a few microseconds, bounds it. The design materialises nothing:
// - A block of round_up(C, 32) threads (at most kMaxThreads, stepping over
//   the slots beyond) takes one query; thread s gathers slot s, a warp's 32
//   lanes one 128-byte adjacency row at M0 = 32, so the loads coalesce.
// - The block stages its candidate ids and its beam (padded with -1 to a
//   multiple of four) in shared memory, (round4(C) + round4(ef)) x 4 bytes,
//   1,312 at C = 128, ef = 200; one __syncthreads follows.
// - Duplicates inside a warp are settled by __match_any_sync (a lane is a
//   duplicate where a lower lane holds its id); those of earlier warps and
//   the beam by a warp-uniform scan of shared memory, 16 bytes a step: every
//   lane reads the same address, a broadcast with no bank conflict, and no
//   lane diverges. A warp none of whose lanes is still valid skips the scan.
// - Any E, M0, ef and B: the shapes come from the arguments; an ef whose
//   shared memory passes kSmemMax is refused (hop_expand_shared_bytes is 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
// the shared memory a block may use on Hopper (227 KB)
constexpr int kSmemMax = 232448;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ inline long long shared_bytes(int C, int ef) {
    return ((long long)round4(C) + round4(ef)) * 4;
}

__device__ inline int differs(int4 v, int id) {
    return (v.x != id) & (v.y != id) & (v.z != id) & (v.w != id);
}

__global__ void __launch_bounds__(kMaxThreads)
    hop_expand_kernel(const int* __restrict__ adj0, const int* __restrict__ sel,
                      const int* __restrict__ beam, int* __restrict__ cand_out,
                      bool* __restrict__ valid_out, int E, int M0, int ef, int N_pad) {
    extern __shared__ int4 smem[];
    int* cand = reinterpret_cast<int*>(smem);
    const int C = E * M0;
    const int c4 = round4(C), ef4 = round4(ef);
    int* beam_s = cand + c4;
    const long long b = blockIdx.x;
    const int* sel_b = sel + b * E;
    const int* beam_b = beam + b * ef;

    for (int s = threadIdx.x; s < C; s += blockDim.x) {
        const int e = s / M0;
        int row = __ldg(sel_b + e);
        int id = -1;
        if (row >= 0) {
            row = min(row, N_pad - 1);
            id = __ldg(adj0 + (long long)row * M0 + (s - e * M0));
        }
        cand[s] = id;
    }
    for (int t = threadIdx.x; t < ef4; t += blockDim.x)
        beam_s[t] = t < ef ? __ldg(beam_b + t) : -1;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const int4* beam4 = reinterpret_cast<const int4*>(beam_s);
    // s0, the warp's first slot, is the same in every lane, and so is each
    // loop's trip count
    for (int s0 = threadIdx.x - lane; s0 < C; s0 += blockDim.x) {
        const int s = s0 + lane;
        const int id = s < C ? cand[s] : -1;
        const unsigned same = __match_any_sync(0xffffffffu, id);
        int ok = id >= 0 && (same & below) == 0;
        if (__any_sync(0xffffffffu, ok)) {
#pragma unroll 4
            for (int j = 0; j < s0 / 4; ++j) ok &= differs(smem[j], id);
#pragma unroll 4
            for (int t = 0; t < ef4 / 4; ++t) ok &= differs(beam4[t], id);
        }
        if (s < C) {
            cand_out[b * C + s] = ok ? id : -1;
            valid_out[b * C + s] = ok != 0;
        }
    }
}

}  // namespace

// the dynamic shared memory of a block for C = E x M0 slots and a beam of
// ef ids, or 0 where it passes what a block may use
extern "C" int hop_expand_shared_bytes(int C, int ef) {
    const long long bytes = shared_bytes(C, ef);
    return C > 0 && ef >= 0 && bytes <= kSmemMax ? (int)bytes : 0;
}

extern "C" int hop_expand(const void* adj0, const void* sel, const void* beam, void* cand,
                          void* valid, int B, int E, int M0, int ef, int N_pad, void* stream) {
    const int C = E * M0;
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const int smem = hop_expand_shared_bytes(C, ef);
    if (smem == 0 || N_pad <= 0) return (int)cudaErrorInvalidValue;
    // shared memory above the 48 KB default (a wide beam), set once per
    // device, at an eager call (never inside a graph capture)
    static bool sized[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (smem > kDefaultSmem && (dev >= 64 || !sized[dev])) {
        const cudaError_t err = cudaFuncSetAttribute(
            hop_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) sized[dev] = true;
    }
    const int threads = C >= kMaxThreads ? kMaxThreads : (C + 31) / 32 * 32;
    hop_expand_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const int*)adj0, (const int*)sel, (const int*)beam, (int*)cand, (bool*)valid, E, M0,
        ef, N_pad);
    return (int)cudaGetLastError();
}

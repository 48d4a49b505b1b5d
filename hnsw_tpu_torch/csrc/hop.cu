// Fused gather + score of packed HNSW neighbourhoods for the hop loop.
//
// Replaces the TPU kernels hnsw_tpu/ops/pallas_hop.py::hop_score (bf16 pack,
// returns dots and squared norms) and ::hop_score_int8 (int8 codes, returns
// raw dots only).
//
// Contract. For query b and each of its E selected rows sel[b, e] (a negative
// row reads row 0), the block nbr_pack[row] of M0 x D values is read and
//   dots[b, e*M0 + m] = sum_d bf16(q[b, d]) * block[m, d]   (f32 accumulate)
//   csq [b, e*M0 + m] = sum_d block[m, d]^2                 (bf16 pack only)
// The query is rounded to bf16 with round-to-nearest-even, as astype does.
// bf16 x bf16 and bf16 x int8 products are exact in f32, so only the order
// of the f32 sums differs from the reference.
//
// Bound on the H100: device-memory bytes. Each hop reads B*E*M0*D packed
// values (2 bytes bf16, 1 byte int8) once and does 2 (4 with csq) flops per
// value, far below the ~295 flops per byte where compute would start to
// bound. Design: one block per query, the bf16-rounded query held in shared
// memory as f32 (transposed, see load_query), eight warps walking the E*M0
// rows of that query, each lane
// issuing 16-byte loads (8 bf16 or 16 int8 values) so a warp reads 512
// contiguous bytes per step; sums are reduced with warp shuffles. Any B, E
// and M0 are accepted; D must be a multiple of 16 (the pack is padded to 128).
// Rows are clamped into [0, N_pad) so that no input can read outside the pack.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Stage the bf16-rounded query in shared memory, transposed so that element
// j of chunk c sits at qs[j * chunks + c]: the 32 lanes of a warp, which read
// 32 consecutive chunks, then hit 32 consecutive words (no bank conflicts).
__device__ __forceinline__ void load_query(const float* __restrict__ q, float* qs, int D,
                                           int per_chunk) {
    const int chunks = D / per_chunk;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
        qs[(d % per_chunk) * chunks + d / per_chunk] =
            __bfloat162float(__float2bfloat16_rn(q[d]));
    __syncthreads();
}

__device__ __forceinline__ long long clamp_row(int row, int n_pad) {
    row = row < 0 ? 0 : row;
    row = row >= n_pad ? n_pad - 1 : row;
    return (long long)row;
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
    const int chunks = D >> 3;  // 8 bf16 = 16 bytes per chunk
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

__global__ void __launch_bounds__(kThreads)
hop_int8_kernel(const int8_t* __restrict__ codes, const float* __restrict__ queries,
                const int* __restrict__ sel, float* __restrict__ dots,
                int E, int M0, int D, int N_pad) {
    extern __shared__ float qs[];
    const int b = blockIdx.x;
    load_query(queries + (long long)b * D, qs, D, 16);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int C = E * M0;
    const int chunks = D >> 4;  // 16 int8 = 16 bytes per chunk
    for (int r = warp; r < C; r += kWarps) {
        const int e = r / M0, m = r - e * M0;
        const long long row = clamp_row(sel[(long long)b * E + e], N_pad);
        const int4* src = reinterpret_cast<const int4*>(codes + (row * M0 + m) * (long long)D);
        float acc = 0.f;
        for (int c = lane; c < chunks; c += 32) {
            const int4 raw = __ldg(src + c);
            const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float v = (float)(int8_t)((words[w] >> (8 * j)) & 0xff);
                    acc = fmaf(qs[(4 * w + j) * chunks + c], v, acc);
                }
            }
        }
        acc = warp_sum(acc);
        if (lane == 0) dots[(long long)b * C + r] = acc;
    }
}

}  // namespace

extern "C" int hop_score_bf16(const void* pack, const void* queries, const void* sel,
                              void* dots, void* csq, int B, int E, int M0, int D,
                              int N_pad, void* stream) {
    if (B > 0) {
        hop_bf16_kernel<<<B, kThreads, D * sizeof(float), (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)pack, (const float*)queries, (const int*)sel,
            (float*)dots, (float*)csq, E, M0, D, N_pad);
    }
    return (int)cudaGetLastError();
}

extern "C" int hop_score_int8(const void* codes, const void* queries, const void* sel,
                              void* dots, int B, int E, int M0, int D, int N_pad,
                              void* stream) {
    if (B > 0) {
        hop_int8_kernel<<<B, kThreads, D * sizeof(float), (cudaStream_t)stream>>>(
            (const int8_t*)codes, (const float*)queries, (const int*)sel,
            (float*)dots, E, M0, D, N_pad);
    }
    return (int)cudaGetLastError();
}

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
// bound. Any B, E and M0 are accepted; D must be a multiple of 16 (the pack
// is padded to 128). Rows are clamped into [0, N_pad) so that no input can
// read outside the pack.
//
// bf16 (hop_bf16_kernel): one block per query, the bf16-rounded query held in
// shared memory as f32 (transposed, see load_query), eight warps walking the
// E*M0 rows of that query, each lane issuing 16-byte loads (8 bf16 values) so
// a warp reads 512 contiguous bytes per step; sums are reduced with warp
// shuffles.
//
// int8 (hop_int8_kernel): bound by the same bytes, but held by its
// instruction stream when written like the bf16 kernel (76 us of device time
// at the main path's hop against a byte bound of 29 us on the H100,
// PERF.md): per 16 bytes each lane re-read 16 query values from shared
// memory and converted 16 bytes with I2F, which runs at a quarter of the FMA
// rate; a 768-byte row of 48 such chunks ran every row's second step on half
// a warp; and each lane had one load in flight. So a lane owns 8-byte units
// of a row, unit u at bytes [8u, 8u + 8) for u = lane, lane + 32, ... (three
// at D = 768, every step a full warp reading 256 contiguous bytes), and holds
// the bf16-rounded query at those positions in registers for every row its
// warp scores; a warp scores kI8Rows rows at a time with all their loads
// issued before the first product (one row at a time is 8% slower; two or
// eight time the same, scripts/hop_int8_ablate.py); and a byte becomes its
// exact f32 value without I2F: its sign bit flipped (b + 128), byte_perm
// places it in the low byte of 0x4B000000 (2^23 + b + 128), and one
// subtraction of 2^23 + 128 leaves b. Rows longer than 768 bytes run in
// passes of 768 that reload the query slice from L1.

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

// rows a warp scores at once, and the 8-byte units of a row a lane holds in
// one pass: 32 lanes x 3 units cover the main path's 768-byte row
constexpr int kI8Rows = 4;
constexpr int kI8Units = 3;

// acc + the dot of 8 int8 codes with their 8 query values, exactly converted
__device__ __forceinline__ float dot8_int8(uint2 raw, const float (&q)[8], float acc) {
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float v = __fsub_rn(__int_as_float(__byte_perm(w[h], 0x4B000000u, 0x7650 + j)),
                                      8388736.f);
            acc = fmaf(q[4 * h + j], v, acc);
        }
    return acc;
}

// MULTI: rows of more than 32 * kI8Units units, scored in passes that each
// reload the query slice; shorter rows leave the lanes' surplus units idle.
template <bool MULTI>
__global__ void __launch_bounds__(kThreads)
hop_int8_kernel(const int8_t* __restrict__ codes, const float* __restrict__ queries,
                const int* __restrict__ sel, float* __restrict__ dots,
                int E, int M0, int D, int N_pad) {
    extern __shared__ long long block_row[];   // [E]: first pack row of each selected block
    const int b = blockIdx.x;
    for (int e = threadIdx.x; e < E; e += blockDim.x)
        block_row[e] = clamp_row(sel[(long long)b * E + e], N_pad) * M0;
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int C = E * M0;
    const int units = D >> 3;
    const int passes = MULTI ? (units + 32 * kI8Units - 1) / (32 * kI8Units) : 1;
    const float* qrow = queries + (long long)b * D;

    float q[kI8Units][8];
    auto load_slice = [&](int pass) {
#pragma unroll
        for (int i = 0; i < kI8Units; ++i) {
            const int u = (pass * kI8Units + i) * 32 + lane;
            float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
            if (u < units) {
                lo = __ldg(reinterpret_cast<const float4*>(qrow + 8 * u));
                hi = __ldg(reinterpret_cast<const float4*>(qrow + 8 * u + 4));
            }
            const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int k = 0; k < 8; ++k) q[i][k] = __bfloat162float(__float2bfloat16_rn(v[k]));
        }
    };
    if (!MULTI) load_slice(0);

    for (int r0 = warp * kI8Rows; r0 < C; r0 += kWarps * kI8Rows) {
        const uint2* src[kI8Rows];
#pragma unroll
        for (int j = 0; j < kI8Rows; ++j) {
            const int r = min(r0 + j, C - 1);
            const int e = r / M0;
            src[j] = reinterpret_cast<const uint2*>(codes + (block_row[e] + r - e * M0) * D);
        }
        float acc[kI8Rows];
#pragma unroll
        for (int j = 0; j < kI8Rows; ++j) acc[j] = 0.f;
        for (int pass = 0; pass < passes; ++pass) {
            if (MULTI) load_slice(pass);
            uint2 raw[kI8Rows][kI8Units];
#pragma unroll
            for (int j = 0; j < kI8Rows; ++j)
#pragma unroll
                for (int i = 0; i < kI8Units; ++i) {
                    const int u = (pass * kI8Units + i) * 32 + lane;
                    raw[j][i] = u < units ? __ldg(src[j] + u) : make_uint2(0u, 0u);
                }
#pragma unroll
            for (int j = 0; j < kI8Rows; ++j)
#pragma unroll
                for (int i = 0; i < kI8Units; ++i) acc[j] = dot8_int8(raw[j][i], q[i], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kI8Rows; ++j) acc[j] = warp_sum(acc[j]);
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kI8Rows; ++j)
                if (r0 + j < C) dots[(long long)b * C + r0 + j] = acc[j];
        }
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
    if (B > 0 && E > 0) {
        auto kernel = D / 8 > 32 * kI8Units ? hop_int8_kernel<true> : hop_int8_kernel<false>;
        kernel<<<B, kThreads, E * sizeof(long long), (cudaStream_t)stream>>>(
            (const int8_t*)codes, (const float*)queries, (const int*)sel, (float*)dots, E, M0,
            D, N_pad);
    }
    return (int)cudaGetLastError();
}

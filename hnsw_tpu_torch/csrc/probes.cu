// Matmul floors: the tile loop of tile.cuh with the probes' trivial epilogues.
//
// Replaces the TPU probe kernels
//   scripts/_probe_r4e.py::mm_only (mm_kernel)              -> colsum, NT
//   scripts/_probe_r4f.py::mm_only_factory (NT, K-major)    -> colsum, NT / VT
//   scripts/_probe_r5a.py::matmul_only (matmul_only_kernel) -> last_tile, store
//   scripts/_probe_r5c.py::matmul_min (matmul_min_kernel)   -> last_tile, min
//
// Contract.
//   colsum (bf16): out[b, j] = sum over corpus rows r with r mod 128 == j of
//     q_b . v_r, f32, over every row of v [N, D] (NT) or vT [D, N] (K-major).
//     N is a multiple of 128 (the wrapper pads a ragged corpus with zero
//     rows, which add nothing).
//   last_tile (s8 x s8 -> s32): with T = N_used / 128 and g = nt / 128, the
//     products of every 128-row tile t < T are formed; the result holds only
//     the last nt-row tile's, as the TPU grid leaves its output block:
//     store: out[b, j] = q_b . v[N_used - nt + j]
//     min:   out[b, j] = min over s < g of q_b . v[N_used - nt + 128 s + j]
//
// Bound on the H100: tensor-core operations, 2*B*N*D of them; the epilogues
// are one add (colsum) or one compare (min) per product. For last_tile that is
// the bound of the tile loop over every row, which the floor runs by design;
// the output alone depends on the last nt rows (min) or 128 rows (store),
// whose products would take 1/15 or 1/244 of that at N = 31,232. These are
// yardsticks: each is "the port's own tile loop without selection", so a scan
// kernel's time minus its floor's is what its epilogue costs. Design: a block
// owns 64 queries and walks the 128-row tiles of one corpus split (the
// TPU's sequential corpus-tile axis); the corpus is split across blocks where
// the query tiles alone leave SMs idle. colsum keeps 32 (query, column) sums
// per thread and writes one partial per split, summed in split order by
// colsum_merge. last_tile aligns its splits to nt-row tiles, so the last one
// lies in the last split, whose block alone writes. Every product goes
// through the inline asm volatile mma.sync of tile.cuh, so nvcc cannot drop
// the products of the tiles whose results are not kept (Mosaic did, on the
// TPU, for matmul_only).

#include "tile.cuh"

using namespace tile;

namespace {

constexpr int kPairs = BM * BN / kThreads;   // (query, column) pairs per thread
constexpr int kMaxSplits = 16;

__device__ __forceinline__ void split_range(int units, int split, int splits, int& b, int& e) {
    b = (int)((long long)split * units / splits);
    e = (int)((long long)(split + 1) * units / splits);
}

template <bool VT>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const uint8_t* __restrict__ v, const uint8_t* __restrict__ q,
              float* __restrict__ part, int B, int N, int D, int splits) {
    __shared__ __align__(16) uint8_t smem[kSmem];
    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BM, split = blockIdx.y;
    int t_begin, t_end;
    split_range(N / BN, split, splits, t_begin, t_end);

    float acc[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) acc[i] = 0.f;

    product_tiles<false, VT>(v, q, B, D, q0, t_begin, t_end, smem,
                             [&](int, const float* Cs) {
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
            const int e = tid + i * kThreads;
            acc[i] += Cs[(e >> 7) * LDC + (e & (BN - 1))];
        }
    }, N);

#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
        const int e = tid + i * kThreads, row = q0 + (e >> 7);
        if (row < B) part[((long long)split * B + row) * BN + (e & (BN - 1))] = acc[i];
    }
}

// out[b, j] = sum of the S partials [S, B, 128], in split order.
__global__ void colsum_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int B, int splits) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)B * BN;
    if (i >= total) return;
    float s = part[i];
    for (int p = 1; p < splits; ++p) s += part[(long long)p * total + i];
    out[i] = s;
}

template <bool MIN>
__global__ void __launch_bounds__(kThreads)
last_tile_kernel(const uint8_t* __restrict__ v8, const uint8_t* __restrict__ q8,
                 int* __restrict__ out, int B, int N_used, int D, int nt, int splits) {
    __shared__ __align__(16) uint8_t smem[kSmem];
    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BM, split = blockIdx.y;
    const int group = nt / BN;                       // 128-row tiles per nt-row tile
    const int t_last = N_used / BN - group;          // first 128-row tile of the last nt tile
    int u_begin, u_end;
    split_range(N_used / nt, split, splits, u_begin, u_end);

    float mn[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) mn[i] = 3.0e38f;

    product_tiles<true>(v8, q8, B, D, q0, u_begin * group, u_end * group, smem,
                        [&](int tile, const float* Cs) {
        if (tile < t_last) return;                   // block-uniform
        if (MIN) {
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
                const int e = tid + i * kThreads;
                mn[i] = fminf(mn[i], Cs[(e >> 7) * LDC + (e & (BN - 1))]);
            }
        } else if (tile == t_last) {
#pragma unroll
            for (int i = 0; i < kPairs; ++i) {
                const int e = tid + i * kThreads, row = q0 + (e >> 7);
                // s32 dots, exact in f32 below 2^24
                if (row < B) out[(long long)row * BN + (e & (BN - 1))] =
                    (int)Cs[(e >> 7) * LDC + (e & (BN - 1))];
            }
        }
    });

    if (MIN && split == splits - 1) {
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
            const int e = tid + i * kThreads, row = q0 + (e >> 7);
            if (row < B) out[(long long)row * BN + (e & (BN - 1))] = (int)mn[i];
        }
    }
}

}  // namespace

// v: [N, D] bf16 (kmajor = 0) or vT [D, N] bf16 (kmajor = 1); q: [B, D] bf16;
// part: [splits, B, 128] f32 (out itself when splits == 1); out: [B, 128].
extern "C" int colsum_bf16(const void* v, const void* q, void* part, void* out, int B, int N,
                           int D, int kmajor, int splits, void* stream) {
    if (splits < 1 || splits > kMaxSplits || N % BN || (2 * D) % KB) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const dim3 grid((B + BM - 1) / BM, splits);
        cudaStream_t s = (cudaStream_t)stream;
        if (kmajor)
            colsum_kernel<true><<<grid, kThreads, 0, s>>>((const uint8_t*)v, (const uint8_t*)q,
                                                          (float*)part, B, N, D, splits);
        else
            colsum_kernel<false><<<grid, kThreads, 0, s>>>((const uint8_t*)v, (const uint8_t*)q,
                                                           (float*)part, B, N, D, splits);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess || splits == 1) return (int)err;
        const long long total = (long long)B * BN;
        const int threads = 256;
        colsum_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
            (const float*)part, (float*)out, B, splits);
    }
    return (int)cudaGetLastError();
}

// v8: [>= N_used, D] s8; q8: [B, D] s8; out: [B, 128] s32. N_used is a
// multiple of nt, nt of 128.
extern "C" int last_tile_int8(const void* v8, const void* q8, void* out, int B, int N_used, int D,
                              int nt, int take_min, int splits, void* stream) {
    if (splits < 1 || nt < BN || nt % BN || N_used < nt || N_used % nt || D % KB ||
        splits > N_used / nt)
        return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const dim3 grid((B + BM - 1) / BM, splits);
        cudaStream_t s = (cudaStream_t)stream;
        if (take_min)
            last_tile_kernel<true><<<grid, kThreads, 0, s>>>((const uint8_t*)v8, (const uint8_t*)q8,
                                                             (int*)out, B, N_used, D, nt, splits);
        else
            last_tile_kernel<false><<<grid, kThreads, 0, s>>>((const uint8_t*)v8, (const uint8_t*)q8,
                                                              (int*)out, B, N_used, D, nt, splits);
    }
    return (int)cudaGetLastError();
}

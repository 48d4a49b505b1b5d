// Matmul floors: a scan's product loop with the probes' trivial epilogues, on
// the Hopper mainloop of wgmma.cuh (TMA ring, wgmma, resident query block),
// the loop of the bf16 bucket bank. Each is "the new loop without selection",
// so a scan kernel's time minus its floor's is what its epilogue costs.
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
// are nothing (colsum: the sum is the wgmma accumulation) or one compare per
// product of the kept tile (store) or of the last nt rows (min). For
// last_tile that is the bound of the tile loop over every row, which the
// floor runs by design; the output alone depends on the last nt rows (min)
// or 128 rows (store), whose products would take 1/15 or 1/244 of that at
// N = 31,232.
//
// Design. A block owns 64 queries and walks the 128-row tiles of one corpus
// split (the TPU's sequential corpus-tile axis); the corpus is split across
// blocks where the query tiles alone leave SMs idle.
// - colsum: each consumer carries one accumulator set across the split's
//   tiles (wg::consume_sum: scale_d = 0 on the split's first chunk only, no
//   per-tile drain, no epilogue), so the column sum costs no instruction
//   beyond the products; the split's partial is written once and colsum_merge
//   sums the partials in split order. The K-major variant reads vT [D, N] as
//   it lies: a tensor map over vT, boxes of 64 corpus rows x 64 K rows, and
//   wgmma with an MN-major B (imm-trans-b = 1), with no copy to [N, D].
// - last_tile: one template, the epilogue (store or min) its parameter. Its
//   splits are aligned to nt-row tiles, so the last one lies in the last
//   split, whose block alone writes. Each thread keeps 32 int32 values in
//   registers beside its accumulators, in their layout: the running minima
//   over the last nt tile's 128-row tiles (min), or tile t_last's dots
//   (store), and writes them once.
// Every product goes through inline asm volatile wgmma, so nvcc cannot drop
// the products of the tiles whose results are not kept (Mosaic did, on the
// TPU, for matmul_only).

#include <limits.h>

#include "wgmma.cuh"

namespace {

constexpr int BN = wg::BN;
constexpr int kMaxSplits = 16;

__device__ __forceinline__ void split_range(int units, int split, int splits, int& b, int& e) {
    b = (int)((long long)split * units / splits);
    e = (int)((long long)(split + 1) * units / splits);
}

// mm_only (VT = false: v [N, D]) and mm_only_kmajor (VT: vT [D, N]), bf16.
template <bool VT>
__global__ void __launch_bounds__(wg::kThreads, 1)
colsum_kernel(__grid_constant__ const CUtensorMap qmap, __grid_constant__ const CUtensorMap vmap,
              float* __restrict__ part, int B, int N, int nk, int stages, int q_resident,
              int splits) {
    extern __shared__ uint8_t smem_raw[];
    const wg::Ring ring = wg::setup(smem_raw, nk, stages, q_resident);
    const int q0 = blockIdx.x * wg::BM, split = blockIdx.y;
    int t_begin, t_end;
    split_range(N / BN, split, splits, t_begin, t_end);

    if (threadIdx.x < 128) {
        wg::producer_regs();
        if (threadIdx.x == 0)
            wg::produce<VT>(ring, &qmap, &vmap, q0, t_begin, t_end, wg::KB / 2);
    } else {
        wg::consumer_regs();
        float acc[wg::kAcc];
        wg::consume_sum<VT>(ring, t_begin, t_end, acc);
        const wg::Frag f = wg::frag();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + f.row0 + 8 * h;
            if (row >= B) continue;
            float* dst = part + ((long long)split * B + row) * BN + f.col0;
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j)
                *reinterpret_cast<float2*>(dst + 8 * j) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
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

// matmul_only (MIN = false) and matmul_min (MIN), s8.
template <bool MIN>
__global__ void __launch_bounds__(wg::kThreads, 1)
last_tile_kernel(__grid_constant__ const CUtensorMap qmap,
                 __grid_constant__ const CUtensorMap vmap, int* __restrict__ out, int B,
                 int N_used, int nt, int nk, int stages, int q_resident, int splits) {
    extern __shared__ uint8_t smem_raw[];
    const wg::Ring ring = wg::setup(smem_raw, nk, stages, q_resident);
    const int q0 = blockIdx.x * wg::BM, split = blockIdx.y;
    const int group = nt / BN;                       // 128-row tiles per nt-row tile
    const int t_last = N_used / BN - group;          // first 128-row tile of the last nt tile
    int u_begin, u_end;
    split_range(N_used / nt, split, splits, u_begin, u_end);

    if (threadIdx.x < 128) {
        wg::producer_regs();
        if (threadIdx.x == 0)
            wg::produce(ring, &qmap, &vmap, q0, u_begin * group, u_end * group, wg::KB);
    } else {
        wg::consumer_regs();
        const wg::Frag f = wg::frag();
        // The minimum over the kept tiles, in registers: the last nt tile's
        // (min), or the one tile t_last (store: the minimum over one tile is
        // that tile). Not a copy: ptxas turns a copy into selects run on
        // every chunk, each behind a wait for the accumulators; the minimum
        // stays behind the branch. Nor a store straight from the
        // accumulators: a read of them under the per-thread row < B test
        // makes ptxas serialise every wgmma of the kernel (info C7518).
        int kept[wg::kAcc];
#pragma unroll
        for (int i = 0; i < wg::kAcc; ++i) kept[i] = INT_MAX;
        wg::consume<int>(ring, u_begin * group, u_end * group, [](int) {},
                         [&](auto& acc, int tile) {
            if (MIN ? tile < t_last : tile != t_last) return;   // block-uniform
#pragma unroll
            for (int i = 0; i < wg::kAcc; ++i) kept[i] = min(kept[i], acc[i]);
        });
        if (split != splits - 1) return;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + f.row0 + 8 * h;
            if (row >= B) continue;
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j)
                *reinterpret_cast<int2*>(out + (long long)row * BN + f.col0 + 8 * j) =
                    make_int2(kept[4 * j + 2 * h], kept[4 * j + 2 * h + 1]);
        }
    }
}

}  // namespace

// v: [N, D] bf16 (kmajor = 0) or vT [D, N] bf16 (kmajor = 1); q: [B, D] bf16;
// part: [splits, B, 128] f32 (out itself when splits == 1); out: [B, 128].
extern "C" int colsum_bf16(const void* v, const void* q, void* part, void* out, int B, int N,
                           int D, int kmajor, int splits, void* stream) {
    if (splits < 1 || splits > kMaxSplits || N % BN || (2 * D) % wg::KB)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const int row_bytes = 2 * D;
    const wg::Plan p = wg::plan(row_bytes);
    CUtensorMap qmap, vmap;
    int err = wg::encode_rows(&qmap, q, row_bytes, B, wg::BM, false);
    if (err == 0)
        err = kmajor ? wg::encode_rows(&vmap, v, 2 * N, D, wg::WN, false)
                     : wg::encode_rows(&vmap, v, row_bytes, N, BN, false);
    if (err != 0) return err;
    auto kernel = kmajor ? colsum_kernel<true> : colsum_kernel<false>;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((B + wg::BM - 1) / wg::BM, splits);
    kernel<<<grid, wg::kThreads, p.smem, s>>>(qmap, vmap, (float*)part, B, N, row_bytes / wg::KB,
                                              p.stages, p.q_resident, splits);
    err = (int)cudaGetLastError();
    if (err != 0 || splits == 1) return err;
    const long long total = (long long)B * BN;
    const int threads = 256;
    colsum_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
        (const float*)part, (float*)out, B, splits);
    return (int)cudaGetLastError();
}

// v8: [>= N_used, D] s8; q8: [B, D] s8; out: [B, 128] s32. N_used is a
// multiple of nt, nt of 128.
extern "C" int last_tile_int8(const void* v8, const void* q8, void* out, int B, int N_used, int D,
                              int nt, int take_min, int splits, void* stream) {
    if (splits < 1 || nt < BN || nt % BN || N_used < nt || N_used % nt || D % wg::KB ||
        splits > N_used / nt)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const wg::Plan p = wg::plan(D);
    CUtensorMap qmap, vmap;
    int err = wg::encode_rows(&qmap, q8, D, B, wg::BM, true);
    if (err == 0) err = wg::encode_rows(&vmap, v8, D, N_used, BN, true);
    if (err != 0) return err;
    auto kernel = take_min ? last_tile_kernel<true> : last_tile_kernel<false>;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
    const dim3 grid((B + wg::BM - 1) / wg::BM, splits);
    kernel<<<grid, wg::kThreads, p.smem, (cudaStream_t)stream>>>(
        qmap, vmap, (int*)out, B, N_used, nt, D / wg::KB, p.stages, p.q_resident, splits);
    return (int)cudaGetLastError();
}

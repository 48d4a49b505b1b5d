// The 64 x 128 product-tile loop of the flat-scan kernels: the sweep kernels
// (sweep.cu), the packed kernel (scan.cu) and the matmul floors (probes.cu)
// call it; the bucketed kernels of scan.cu keep the same loop inline (see
// there).
//
// A block of 256 threads owns 64 queries and walks a range of 128-row corpus
// tiles. Eight warps compute each 64 x 128 product tile with mma.sync
// (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32) from 128-byte K chunks staged in
// shared memory; the next chunk's global loads are in flight during the
// current chunk's products. After the last chunk of a tile the products are
// written to shared memory as f32 ([BM][LDC], s32 dots converted exactly for
// |dot| < 2^24) and every thread calls epilogue(tile, Cs). The shared buffer
// is synchronised before and after that write, and again before the next
// tile's staging overwrites it, so an epilogue may read Cs freely but must
// not write it.
//
// VT = true (bf16 only) reads the corpus K-major, as vT [D, ldv] (ldv corpus
// rows per K row): each staged chunk is 64 K rows of 128 corpus rows, copied
// as it lies ([64][LDT] bytes), and the B fragments are read with
// ldmatrix.trans. VT = false is the loop the scan kernels use, unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int BM = 64;          // queries per block
constexpr int BN = 128;         // corpus rows per tile
constexpr int KB = 128;         // bytes of K per staged chunk
constexpr int LDS = KB + 16;    // padded smem row (36 words: conflict-free fragments)
constexpr int LDC = BN + 4;     // padded f32 product-tile row
constexpr int LDT = 2 * BN + 16;  // padded K-major smem row (68 words: conflict-free ldmatrix)
constexpr int kThreads = 256;
constexpr float BIG = 1e30f;
constexpr int kSmem = (BM * LDC * 4 > (BM + BN) * LDS) ? BM * LDC * 4 : (BM + BN) * LDS;

enum { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };

template <bool INT8>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma<false>(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s8 products accumulate exactly in s32; the accumulator registers carry the
// s32 bit patterns and are converted to f32 once per tile.
template <>
__device__ __forceinline__ void mma<true>(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
    int* di = reinterpret_cast<int*>(d);
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(di[0]), "+r"(di[1]), "+r"(di[2]), "+r"(di[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Products of queries [q0, q0 + BM) with the corpus tiles [t_begin, t_end).
// Rows are row_bytes = D (s8) or 2 * D (bf16) bytes, a multiple of KB; query
// rows >= B are read as zeros. smem holds kSmem bytes, 16-byte aligned. With
// VT the corpus is vT [D, ldv] bf16 (ldv a multiple of 8).
template <bool INT8, bool VT = false, typename Epilogue>
__device__ __forceinline__ void product_tiles(const uint8_t* __restrict__ vectors,
                                              const uint8_t* __restrict__ queries, int B,
                                              int D, int q0, int t_begin, int t_end,
                                              uint8_t* smem, Epilogue&& epilogue,
                                              int ldv = 0) {
    static_assert(!(VT && INT8), "the K-major corpus is bf16");
    static_assert(!VT || BM * LDS + (KB / 2) * LDT <= kSmem, "K-major chunk fits");
    uint8_t* Qs = smem;                 // [BM][LDS] bytes of the query chunk
    uint8_t* Vs = smem + BM * LDS;      // [BN][LDS] (VT: [KB/2][LDT]) bytes of the corpus chunk
    float* Cs = reinterpret_cast<float*>(smem);   // [BM][LDC], aliases Qs/Vs

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int warp_m = warp >> 2, warp_n = warp & 3;   // 2 x 4 warps of 32 x 32
    const int row_bytes = INT8 ? D : 2 * D;
    const int nk = row_bytes / KB;
    const long long total = (long long)(t_end - t_begin) * nk;

    float acc[2][4][4];
    uint4 qreg[2], vreg[4];

    auto prefetch = [&](long long it) {
        const int tile = t_begin + (int)(it / nk), kc = (int)(it % nk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int idx = tid + i * kThreads, r = idx >> 3, col = (idx & 7) * 16;
            qreg[i] = (q0 + r < B)
                ? __ldg(reinterpret_cast<const uint4*>(
                      queries + (long long)(q0 + r) * row_bytes + kc * KB + col))
                : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * kThreads;
            if constexpr (VT) {
                // K row kc * 64 + (idx >> 4), 16 bytes of its 128 corpus rows
                const int kr = idx >> 4, col = (idx & 15) * 16;
                vreg[i] = __ldg(reinterpret_cast<const uint4*>(
                    vectors + ((long long)(kc * (KB / 2) + kr) * ldv + tile * BN) * 2 + col));
            } else {
                const int r = idx >> 3, col = (idx & 7) * 16;
                vreg[i] = __ldg(reinterpret_cast<const uint4*>(
                    vectors + (long long)(tile * BN + r) * row_bytes + kc * KB + col));
            }
        }
    };

    if (total > 0) prefetch(0);
    for (long long it = 0; it < total; ++it) {
        const int tile = t_begin + (int)(it / nk), kc = (int)(it % nk);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int idx = tid + i * kThreads;
            *reinterpret_cast<uint4*>(Qs + (idx >> 3) * LDS + (idx & 7) * 16) = qreg[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * kThreads;
            if constexpr (VT)
                *reinterpret_cast<uint4*>(Vs + (idx >> 4) * LDT + (idx & 15) * 16) = vreg[i];
            else
                *reinterpret_cast<uint4*>(Vs + (idx >> 3) * LDS + (idx & 7) * 16) = vreg[i];
        }
        __syncthreads();
        if (it + 1 < total) prefetch(it + 1);
        if (kc == 0) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;   // also s32 zero
        }
        // four 32-byte k-steps per chunk: k16 for bf16, k32 for s8 (same bytes)
#pragma unroll
        for (int ks = 0; ks < KB; ks += 32) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const uint8_t* p = Qs + (warp_m * 32 + mi * 16 + g) * LDS + ks + t4 * 4;
                a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
                a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
                a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
            }
            if constexpr (VT) {
                // four 8x8 K x N matrices per ldmatrix.x4.trans: (K 0-7, ni),
                // (K 8-15, ni), (K 0-7, ni + 1), (K 8-15, ni + 1); each lane
                // gets K rows 2*t4, 2*t4 + 1 of column g, the col-major B
                // fragment of m16n8k16
#pragma unroll
                for (int ni = 0; ni < 4; ni += 2) {
                    const int kr = ks / 2 + ((lane >> 3) & 1) * 8 + (lane & 7);
                    const int nc = warp_n * 32 + ni * 8 + (lane >> 4) * 8;
                    const uint32_t addr = static_cast<uint32_t>(
                        __cvta_generic_to_shared(Vs + kr * LDT + nc * 2));
                    asm volatile(
                        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                        : "=r"(b[ni][0]), "=r"(b[ni][1]), "=r"(b[ni + 1][0]), "=r"(b[ni + 1][1])
                        : "r"(addr));
                }
            } else {
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    const uint8_t* p = Vs + (warp_n * 32 + ni * 8 + g) * LDS + ks + t4 * 4;
                    b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
                    b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma<INT8>(acc[mi][ni], a[mi], b[ni]);
        }
        if (kc != nk - 1) continue;

        // tile complete: products -> Cs -> epilogue
        __syncthreads();
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int r0 = warp_m * 32 + mi * 16 + g;
                const int c0 = warp_n * 32 + ni * 8 + t4 * 2;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float v = acc[mi][ni][j];
                    if (INT8) v = (float)__float_as_int(v);
                    Cs[(r0 + (j >> 1) * 8) * LDC + c0 + (j & 1)] = v;
                }
            }
        __syncthreads();
        epilogue(tile, Cs);
    }
}

}  // namespace tile

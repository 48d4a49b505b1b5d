// Fused flat scans with an exact running top-k ("sweep"; bf16 and int8).
//
// Replaces the TPU kernels hnsw_tpu/ops/pallas_scan.py::pallas_exact_topk
// (_make_kernel, _tile_topk, _merge_sorted) and ::pallas_int8_topk
// (_make_kernel_int8).
//
// Contract. For every query q and corpus row r the kernel forms the dot
// product on the tensor cores (bf16 x bf16 -> f32, or s8 x s8 -> s32, then
// dequantized as dot * qscale * vscale in that order) and the full metric
// distance, with the reference's operations in the reference's order:
//   cosine    1 - dot / sqrt(max(|q|^2 |v|^2, 1e-12))
//   euclidean sqrt(max((|q|^2 + |v|^2) - 2 dot, 0))
//   dot       -dot
// |q|^2 is summed from the bf16 queries (bf16) or read from qmeta[:, 1]
// (int8); |v|^2 is given. Rows >= n are skipped. The result per query is the
// k smallest (distance, row) pairs in lexicographic order, ascending, with
// (BIG, -1) for missing rows. That is what the reference's k min-sweeps per
// tile and sorted merges compute (ties go to the lower row), so the order
// in which rows are visited does not change the answer.
//
// Bound on the H100: tensor-core operations, 2*B*N*D of them, plus the
// per-element distance. Design, kept simple for this first version: the
// product tiles of tile.cuh (64 queries x 128 rows per block, the corpus cut
// into S splits across blocks). Each warp owns 8 of the block's 64 queries
// and keeps each one's running top-k as a sorted list across its lanes (lane
// i holds slot i). Per tile, each lane scores 4 of the 128 rows; a row whose
// (distance, row) beats the list's last slot is inserted, one at a time
// through the warp (ballot, then a shift of the lanes above the insert
// point). After a few tiles almost no row passes, so the selection costs a
// compare per element. Each split writes its list; sweep_merge merges the S
// sorted lists of a query. The distance epilogue is written with
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn so that nvcc contracts
// nothing into an FMA that the plain version does not form.

#include "tile.cuh"

using namespace tile;

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kQPerWarp = BM / kWarps;       // queries per warp
constexpr int kMaxK = 32;                    // one list slot per lane
constexpr int kMaxSplits = 16;
constexpr int NO_ROW = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// lexicographic (distance, row) order
__device__ __forceinline__ bool before(float a, int ar, float b, int br) {
    return a < b || (a == b && ar < br);
}

__device__ __forceinline__ float distance(float dot, float qsq, float vsq, int metric) {
    if (metric == COSINE) {
        const float denom = __fsqrt_rn(fmaxf(__fmul_rn(qsq, vsq), 1e-12f));
        return __fsub_rn(1.f, __fdiv_rn(dot, denom));
    }
    if (metric == EUCLIDEAN) {
        return __fsqrt_rn(fmaxf(__fsub_rn(__fadd_rn(qsq, vsq), __fmul_rn(2.f, dot)), 0.f));
    }
    return -dot;
}

template <bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(const uint8_t* __restrict__ vectors, const float* __restrict__ v_sq,
             const float* __restrict__ vscale, const uint8_t* __restrict__ queries,
             const float* __restrict__ qmeta, float* __restrict__ part_d,
             int* __restrict__ part_r, int B, int N_pad, int D, int n, int k, int metric,
             int splits) {
    __shared__ __align__(16) uint8_t smem[kSmem];
    __shared__ float qsq_s[BM];
    __shared__ float qs_s[BM];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * BM;
    const int split = blockIdx.y;
    const int ntiles_all = N_pad / BN;
    const int t_begin = (int)((long long)split * ntiles_all / splits);
    const int t_end = (int)((long long)(split + 1) * ntiles_all / splits);

#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
        const int ql = warp * kQPerWarp + i, q = q0 + ql;
        if (INT8) {
            if (lane == 0) {
                qs_s[ql] = q < B ? qmeta[2 * q] : 0.f;
                qsq_s[ql] = q < B ? qmeta[2 * q + 1] : 0.f;
            }
        } else {
            // |q|^2 of the bf16 query, widened exactly, summed in f32
            float s = 0.f;
            if (q < B) {
                const uint16_t* row = reinterpret_cast<const uint16_t*>(queries) + (long long)q * D;
                for (int j = lane; j < D; j += 32) {
                    const float x = __uint_as_float((uint32_t)row[j] << 16);
                    s = __fadd_rn(s, __fmul_rn(x, x));
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
            if (lane == 0) qsq_s[ql] = s;
        }
    }
    __syncthreads();

    // running lists: lane i < k holds slot i of query warp*8 + i'
    float ld[kQPerWarp];
    int lr[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) { ld[i] = BIG; lr[i] = NO_ROW; }

    product_tiles<INT8>(vectors, queries, B, D, q0, t_begin, t_end, smem,
                        [&](int tile, const float* Cs) {
        float vsq[4], vs[4];
        int row[4];
        bool live[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            row[j] = tile * BN + lane + 32 * j;
            live[j] = row[j] < n;
            vsq[j] = v_sq[row[j]];
            vs[j] = INT8 ? vscale[row[j]] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kQPerWarp; ++i) {
            const int ql = warp * kQPerWarp + i;
            if (q0 + ql >= B) continue;          // warp-uniform
            const float qsq = qsq_s[ql], qs = qs_s[ql];
            float d[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float dot = Cs[ql * LDC + lane + 32 * j];
                if (INT8) dot = __fmul_rn(__fmul_rn(dot, qs), vs[j]);
                d[j] = distance(dot, qsq, vsq[j], metric);
            }
            float worst = __shfl_sync(FULL, ld[i], k - 1);
            int worst_r = __shfl_sync(FULL, lr[i], k - 1);
            unsigned pending = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (live[j] && before(d[j], row[j], worst, worst_r)) pending |= 1u << j;
            for (;;) {
                const unsigned m = __ballot_sync(FULL, pending != 0);
                if (m == 0) break;
                const int src = __ffs(m) - 1;
                const int jj = pending ? __ffs(pending) - 1 : 0;
                const float my_d = jj == 0 ? d[0] : jj == 1 ? d[1] : jj == 2 ? d[2] : d[3];
                const int my_r = jj == 0 ? row[0] : jj == 1 ? row[1] : jj == 2 ? row[2] : row[3];
                const float cd = __shfl_sync(FULL, my_d, src);
                const int cr = __shfl_sync(FULL, my_r, src);
                if (lane == src) pending &= pending - 1;
                // the list may have tightened since this row was marked
                if (!before(cd, cr, worst, worst_r)) continue;
                const int pos = __popc(__ballot_sync(FULL, lane < k && before(ld[i], lr[i], cd, cr)));
                const float up_d = __shfl_up_sync(FULL, ld[i], 1);
                const int up_r = __shfl_up_sync(FULL, lr[i], 1);
                if (lane == pos) {
                    ld[i] = cd; lr[i] = cr;
                } else if (lane > pos) {
                    ld[i] = up_d; lr[i] = up_r;
                }
                worst = __shfl_sync(FULL, ld[i], k - 1);
                worst_r = __shfl_sync(FULL, lr[i], k - 1);
            }
        }
    });

#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
        const int q = q0 + warp * kQPerWarp + i;
        if (q >= B || lane >= k) continue;
        const long long o = ((long long)split * B + q) * k + lane;
        part_d[o] = ld[i];
        part_r[o] = ld[i] < BIG ? lr[i] : -1;
    }
}

// Merge the S sorted partial lists [S, B, k] of each query into [B, k].
__global__ void sweep_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_r,
                                   float* __restrict__ out_d, int* __restrict__ out_r, int B, int k,
                                   int splits) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= B) return;
    int head[kMaxSplits];
    for (int s = 0; s < splits; ++s) head[s] = 0;
    for (int j = 0; j < k; ++j) {
        int best = 0;
        float bd = BIG;
        int br = NO_ROW;
        bool found = false;
        for (int s = 0; s < splits; ++s) {
            if (head[s] >= k) continue;
            const long long p = ((long long)s * B + q) * k + head[s];
            const float d = part_d[p];
            const int r = part_r[p] < 0 ? NO_ROW : part_r[p];
            if (!found || before(d, r, bd, br)) {
                best = s; bd = d; br = r; found = true;
            }
        }
        head[best] += 1;
        out_d[(long long)q * k + j] = bd;
        out_r[(long long)q * k + j] = bd < BIG ? br : -1;
    }
}

}  // namespace

extern "C" int sweep_topk_bf16(const void* vectors, const void* v_sq, const void* queries,
                               void* part_d, void* part_r, int B, int N_pad, int D, int n, int k,
                               int metric, int splits, void* stream) {
    if (k < 1 || k > kMaxK || splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const dim3 grid((B + BM - 1) / BM, splits);
        sweep_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)vectors, (const float*)v_sq, nullptr, (const uint8_t*)queries,
            nullptr, (float*)part_d, (int*)part_r, B, N_pad, D, n, k, metric, splits);
    }
    return (int)cudaGetLastError();
}

extern "C" int sweep_topk_int8(const void* v8, const void* v_sq, const void* vscale,
                               const void* q8, const void* qmeta, void* part_d, void* part_r,
                               int B, int N_pad, int D, int n, int k, int metric, int splits,
                               void* stream) {
    if (k < 1 || k > kMaxK || splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const dim3 grid((B + BM - 1) / BM, splits);
        sweep_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)v8, (const float*)v_sq, (const float*)vscale, (const uint8_t*)q8,
            (const float*)qmeta, (float*)part_d, (int*)part_r, B, N_pad, D, n, k, metric,
            splits);
    }
    return (int)cudaGetLastError();
}

extern "C" int sweep_merge(const void* part_d, const void* part_r, void* out_d, void* out_r,
                           int B, int k, int splits, void* stream) {
    if (k < 1 || k > kMaxK || splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int threads = 128;
        sweep_merge_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            (const float*)part_d, (const int*)part_r, (float*)out_d, (int*)out_r, B, k, splits);
    }
    return (int)cudaGetLastError();
}

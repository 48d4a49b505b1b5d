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
// bf16 (hop_bf16_ring_kernel): a selected block nbr_pack[row] is one
// contiguous run of M0 * D * 2 bytes (48 KiB at D = 768, 8 KiB at D = 128),
// so it is moved by the bulk copy engine (cp.async.bulk, TMA without a
// tensor map), as the TPU kernel moves it with asynchronous block copies.
// The kernel it replaced had each warp load one row in 16-byte pieces and
// reduce it before the next, so a warp had one row's loads in flight and
// the SM only as many as it had warps resident; at D = 128 half of each
// warp idled. Here:
// - Groups. A selected block is cut into groups: kStageBytes / (2 D) whole
//   rows (8 rows at D = 768, the whole block at D = 128), or, for a row
//   longer than a stage, one row in `pieces` stages. Groups are numbered
//   query by query, block by block; persistent blocks (kBlocksPerSM per SM)
//   each take one contiguous range of them, so every block has the same
//   bytes to within one group and a query changes only at a range's edges.
// - The producer warp walks its block's groups: its lanes load the rows of
//   the next 32 groups from sel while lane 0 issues one bulk copy per stage
//   of the current 32 into a ring of kStages stages of kStageBytes, each
//   with a full mbarrier (expect_tx, completed by the copy's bytes) and an
//   empty one; 192 KiB are in flight per SM at D = 768, 128 KiB at D = 128.
//   It steps its group counters rather than dividing: one thread issues
//   every copy of the SM, so its work per group bounds the SM's rate (two
//   64-bit divisions a group held it at about one group per 0.4 us).
// - Consumer warp w takes the groups w, w + 8, ... of the range: stage j of
//   the range lies in slot j % kStages at parity (j / kStages) & 1. Lanes
//   are mapped to (row, 16-byte chunk) over the stage: `lanes` lanes share
//   a row (its chunks rounded up to a power of two, at most 32), 32 / lanes
//   rows per warp-step, each lane taking chunks sub, sub + lanes, ... (two
//   rows a step at D = 128, three chunks a lane of one row at D = 768:
//   every lane busy). A warp loads kSteps warp-steps at once, forms their
//   products with the steps innermost (2 * kSteps independent FMA chains),
//   releases the stage, and only then reduces each row with shuffles over
//   its own lanes: the shuffle rounds are the longest part of a group, and
//   a stage held through them is a copy not in flight. Row r of a window of
//   32 rows ends in lane r, and the window is stored with one coalesced
//   store per output.
// - The bf16-rounded query slice of a lane's chunks is held in registers
//   (NC = 1 or kRegChunks chunks a lane, a template argument, so that the
//   loads of a batch are issued back to back, a chunk past the stage's
//   rows reading 16 zero bytes) and fetched from L2 one group ahead of its
//   use. Wider rows, and rows in pieces, read it per chunk through L1
//   (NC = 0).
// No wgmma: each query meets only its own E * M0 rows, so there is no
// 64-row tile of queries that share a block, and csq needs every element
// squared on the CUDA cores anyway.
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

__device__ __forceinline__ long long clamp_row(int row, int n_pad) {
    row = row < 0 ? 0 : row;
    row = row >= n_pad ? n_pad - 1 : row;
    return (long long)row;
}

// ---------------------------------------------------------------------------
// bf16: the bulk-copy ring
// ---------------------------------------------------------------------------

constexpr int kConsumerWarps = 8;
constexpr int kRingThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr int kStageBytes = 12288;
constexpr int kStages = 16;
constexpr int kBlocksPerSM = 1;
constexpr int kRegChunks = 3;
// the ring, its full and empty barriers, and a zero chunk
constexpr int kRingSmem = kStages * (kStageBytes + 16) + 16;

// One launch's cut of a selected block into groups (see the note above).
struct RingPlan {
    int chunks;    // 16-byte chunks of a row, D / 8
    int lanes;     // lanes that share a row
    int per_lane;  // chunks a lane takes of each row
    int rows;      // rows of a group; 0: a group is one row in pieces
    int pieces;    // stages of a group
    int groups;    // groups of a selected block
};

RingPlan ring_plan(int M0, int D) {
    RingPlan p;
    const int row_bytes = 2 * D;
    p.chunks = D / 8;
    p.lanes = 1;
    while (p.lanes < p.chunks && p.lanes < 32) p.lanes *= 2;
    p.per_lane = (p.chunks + p.lanes - 1) / p.lanes;
    if (row_bytes <= kStageBytes) {
        p.rows = M0 < kStageBytes / row_bytes ? M0 : kStageBytes / row_bytes;
        p.pieces = 1;
        p.groups = (M0 + p.rows - 1) / p.rows;
    } else {
        p.rows = 0;
        p.pieces = (row_bytes + kStageBytes - 1) / kStageBytes;
        p.groups = M0;
    }
    return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), counted on the barrier's transaction count when they land
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// the bf16-rounded query values of chunk c (8 values)
__device__ __forceinline__ void query8(const float* qrow, int c, float (&q)[8]) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(qrow) + 2 * c);
    const float4 hi = __ldg(reinterpret_cast<const float4*>(qrow) + 2 * c + 1);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = __bfloat162float(__float2bfloat16_rn(v[k]));
}

// acc += the dot of one 16-byte chunk (8 bf16) with q, sq += its squares
__device__ __forceinline__ void dot8(uint4 raw, const float (&q)[8], float& acc, float& sq) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(h[j]);
        acc = fmaf(q[2 * j], v.x, acc);
        acc = fmaf(q[2 * j + 1], v.y, acc);
        sq = fmaf(v.x, v.x, sq);
        sq = fmaf(v.y, v.y, sq);
    }
}

// NC > 0: groups of whole rows of which a lane takes at most NC chunks, the
// query slice held in registers; NC = 0: wider rows, or rows in pieces, the
// query read per chunk.
template <int NC>
__global__ void __launch_bounds__(kRingThreads, kBlocksPerSM)
hop_bf16_ring_kernel(const __nv_bfloat16* __restrict__ pack, const float* __restrict__ queries,
                     const int* __restrict__ sel, float* __restrict__ dots,
                     float* __restrict__ csq, int E, int M0, int D, int N_pad, RingPlan plan,
                     long long total) {
    extern __shared__ __align__(128) uint8_t ring[];
    const uint32_t ring0 = smem_u32(ring);
    const uint32_t full0 = ring0 + kStages * kStageBytes, empty0 = full0 + 8 * kStages;
    // 16 zero bytes: what a lane reads for a chunk outside its stage's rows
    uint4* zero = reinterpret_cast<uint4*>(ring + kStages * (kStageBytes + 16));
    if (threadIdx.x == 0) {
        *zero = make_uint4(0u, 0u, 0u, 0u);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // this block's groups [g0, g0 + n): group g0 + i is group r0 + i of
    // the queries from b0 on (one 64-bit division here, 32-bit ones below)
    const long long g0 = total * blockIdx.x / gridDim.x;
    const int n = (int)(total * (blockIdx.x + 1) / gridDim.x - g0);
    const int per_query = E * plan.groups;
    const long long b0 = g0 / per_query;
    const int r0 = (int)(g0 - b0 * per_query);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp == kConsumerWarps) {
        // the producer warp: lane t loads the block row of group i0 + t for
        // a batch of 32 groups while the batch before it is issued, so no
        // copy waits on a load of sel; lane 0 issues the copies
        const long long row_bytes = 2LL * D;
        auto row_of = [&](int i) -> long long {
            if (i >= n) return 0;
            const unsigned t = r0 + i, db = t / per_query;
            const int e = (t - db * per_query) / plan.groups;
            return clamp_row(__ldg(sel + (b0 + db) * E + e), N_pad);
        };
        // the group index within its block, stepped along with i
        int gi = r0 % plan.groups;
        long long next = row_of(lane);
        for (int i0 = 0; i0 < n; i0 += 32) {
            const long long batch = next;
            next = row_of(i0 + 32 + lane);
            for (int t = 0; t < 32 && i0 + t < n; ++t) {
                const int i = i0 + t;
                const long long row = __shfl_sync(0xffffffffu, batch, t);
                const int first = plan.rows ? gi * plan.rows : gi;
                const int bytes = plan.rows ? min(plan.rows, M0 - first) * (int)row_bytes
                                            : (int)row_bytes;
                const char* src =
                    reinterpret_cast<const char*>(pack) + (row * M0 + first) * row_bytes;
                for (int p = 0; p < plan.pieces; ++p) {
                    const int j = i * plan.pieces + p, slot = j % kStages;
                    mbar_wait(empty0 + 8 * slot, ((j / kStages) & 1) ^ 1);
                    if (lane == 0) {
                        const int piece = min(kStageBytes, bytes - p * kStageBytes);
                        mbar_expect_tx(full0 + 8 * slot, piece);
                        bulk_load(ring0 + slot * kStageBytes, src + (long long)p * kStageBytes,
                                  piece, full0 + 8 * slot);
                    }
                    __syncwarp();
                }
                if (++gi == plan.groups) gi = 0;
            }
        }
        return;
    }

    // lanes is a power of two: the lane's row of a warp-step and first
    // chunk of it, the rows a warp-step, and where the lane's window row
    // sits after the row reduction
    const int my_row = lane / plan.lanes, sub = lane & (plan.lanes - 1);
    const int R = 32 / plan.lanes;
    const int keep_step = lane / R, keep_src = (lane & (R - 1)) * plan.lanes;
    // NC > 0: the bf16-rounded slice of the current group's query (q), and
    // the raw slice of the next query this warp meets, fetched one group
    // ahead so that no group waits on its query's load
    constexpr int kQ = NC > 0 ? NC : 1;
    // warp-steps scored at once: a whole 32-row stage at D = 128
    constexpr int kSteps = NC == 1 ? 16 : 8;
    float q[kQ][8], qn[kQ][8];
    long long q_of = -1, qn_of = -1;
    auto fetch = [&](long long bq) {
        qn_of = bq;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
            const int c = sub + k * plan.lanes;
            const float4* src = reinterpret_cast<const float4*>(queries + bq * D) + 2 * c;
            const float4 lo = c < plan.chunks ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 hi = c < plan.chunks ? __ldg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
            qn[k][0] = lo.x; qn[k][1] = lo.y; qn[k][2] = lo.z; qn[k][3] = lo.w;
            qn[k][4] = hi.x; qn[k][5] = hi.y; qn[k][6] = hi.z; qn[k][7] = hi.w;
        }
    };
    for (int i = warp; i < n; i += kConsumerWarps) {
        const unsigned t = r0 + i, db = t / per_query;
        const long long b = b0 + db;
        const int r = t - db * per_query, e = r / plan.groups, gi = r - e * plan.groups;
        const float* qrow = queries + b * D;
        const long long out = (b * E + e) * M0;
        if (NC > 0 && b != q_of) {
            if (qn_of != b) fetch(b);
            q_of = b;
#pragma unroll
            for (int k = 0; k < kQ; ++k)
#pragma unroll
                for (int t = 0; t < 8; ++t)
                    q[k][t] = __bfloat162float(__float2bfloat16_rn(qn[k][t]));
        }
        if (NC > 0 && i + kConsumerWarps < n) {
            const long long b2 = b0 + (t + kConsumerWarps) / per_query;
            if (b2 != q_of && b2 != qn_of) fetch(b2);
        }
        if (NC == 0 && plan.rows == 0) {
            // one row in pieces: chunks [c0, c0 + per_stage) of it per stage
            constexpr int per_stage = kStageBytes / 16;
            float acc = 0.f, sq = 0.f;
            for (int p = 0; p < plan.pieces; ++p) {
                const int j = i * plan.pieces + p, slot = j % kStages;
                mbar_wait(full0 + 8 * slot, (j / kStages) & 1);
                const uint4* st = reinterpret_cast<const uint4*>(ring + slot * kStageBytes);
                const int c0 = p * per_stage, cn = min(per_stage, plan.chunks - c0);
                for (int c = lane; c < cn; c += 32) {
                    float qv[8];
                    query8(qrow, c0 + c, qv);
                    dot8(st[c], qv, acc, sq);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty0 + 8 * slot);
            }
            acc = warp_sum(acc);
            sq = warp_sum(sq);
            if (lane == 0) {
                dots[out + gi] = acc;
                csq[out + gi] = sq;
            }
            continue;
        }
        const int first = gi * plan.rows, nr = min(plan.rows, M0 - first);
        const int slot = i % kStages;
        mbar_wait(full0 + 8 * slot, (i / kStages) & 1);
        const uint4* st = reinterpret_cast<const uint4*>(ring + slot * kStageBytes);
        float keep_d = 0.f, keep_c = 0.f;  // row (window + lane) of this 32-row window
        // kSteps warp-steps at a time: all their loads first (a chunk outside
        // the stage's rows reads the zero chunk), then their products; the
        // stage is released after the last products, before the shuffle
        // reductions, so that the next copy into it starts early
        for (int s0 = 0; s0 * R < nr; s0 += kSteps) {
            float acc[kSteps], sq[kSteps];
            if (NC > 0) {
                uint4 raw[kSteps][kQ];
#pragma unroll
                for (int u = 0; u < kSteps; ++u) {
                    const int row = (s0 + u) * R + my_row;
#pragma unroll
                    for (int k = 0; k < kQ; ++k) {
                        const int c = sub + k * plan.lanes;
                        raw[u][k] = *(row < nr && c < plan.chunks ? st + row * plan.chunks + c
                                                                  : zero);
                    }
                }
#pragma unroll
                for (int u = 0; u < kSteps; ++u) {
                    acc[u] = 0.f;
                    sq[u] = 0.f;
                }
                // the steps innermost: 2 * kSteps independent FMA chains
#pragma unroll
                for (int k = 0; k < kQ; ++k)
#pragma unroll
                    for (int h = 0; h < 4; ++h)
#pragma unroll
                        for (int u = 0; u < kSteps; ++u) {
                            const uint32_t w = h == 0   ? raw[u][k].x
                                               : h == 1 ? raw[u][k].y
                                               : h == 2 ? raw[u][k].z
                                                        : raw[u][k].w;
                            const float lo = __uint_as_float(w << 16);
                            const float hi = __uint_as_float(w & 0xffff0000u);
                            acc[u] = fmaf(q[k][2 * h], lo, acc[u]);
                            acc[u] = fmaf(q[k][2 * h + 1], hi, acc[u]);
                            sq[u] = fmaf(lo, lo, sq[u]);
                            sq[u] = fmaf(hi, hi, sq[u]);
                        }
            } else {
#pragma unroll
                for (int u = 0; u < kSteps; ++u) {
                    const int row = (s0 + u) * R + my_row;
                    acc[u] = 0.f;
                    sq[u] = 0.f;
                    for (int c = sub; row < nr && c < plan.chunks; c += plan.lanes) {
                        float qv[8];
                        query8(qrow, c, qv);
                        dot8(st[row * plan.chunks + c], qv, acc[u], sq[u]);
                    }
                }
            }
            if ((s0 + kSteps) * R >= nr) {
                __syncwarp();
                if (lane == 0) mbar_arrive(empty0 + 8 * slot);
            }
            for (int off = plan.lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
                for (int u = 0; u < kSteps; ++u) {
                    acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
                    sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], off);
                }
            }
            // a window is `lanes` steps of R rows: 32 rows, row x of it kept
            // by lane x (the rows of a step sit in lanes t * lanes)
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                acc[u] = __shfl_sync(0xffffffffu, acc[u], keep_src);
                sq[u] = __shfl_sync(0xffffffffu, sq[u], keep_src);
            }
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                const int step = s0 + u;
                if (step * R >= nr) break;
                const int in_window = step & (plan.lanes - 1);
                if (keep_step == in_window) {
                    keep_d = acc[u];
                    keep_c = sq[u];
                }
                if (in_window == plan.lanes - 1 || (step + 1) * R >= nr) {
                    const int m = (step - in_window) * R + lane;
                    if (m < nr) {
                        dots[out + first + m] = keep_d;
                        csq[out + first + m] = keep_c;
                    }
                }
            }
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
    if (B <= 0 || E <= 0 || M0 <= 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 0) {  // every sum is empty
        const size_t bytes = (size_t)B * E * M0 * sizeof(float);
        cudaMemsetAsync(dots, 0, bytes, st);
        cudaMemsetAsync(csq, 0, bytes, st);
        return (int)cudaGetLastError();
    }
    const RingPlan plan = ring_plan(M0, D);
    // the chunks a lane holds the query for: one (D <= 256), three (D <= 768;
    // a lane's chunks past the row read the zero chunk) or none
    const int nc = plan.rows == 0 || plan.per_lane > kRegChunks ? 0
                   : plan.per_lane == 1                         ? 1
                                                                : kRegChunks;
    auto kernel = nc == 1 ? hop_bf16_ring_kernel<1>
                  : nc    ? hop_bf16_ring_kernel<kRegChunks>
                          : hop_bf16_ring_kernel<0>;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    // the SM count, and the ring's shared memory above the 48 KB default,
    // looked up and set once per device (and instantiation)
    static int sms_of[64];
    static bool sized[kRegChunks + 1][64];
    if (dev >= 64 || !sms_of[dev]) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (dev < 64) sms_of[dev] = sms;
    } else {
        sms = sms_of[dev];
    }
    if (dev >= 64 || !sized[nc][dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingSmem);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) sized[nc][dev] = true;
    }
    const long long total = (long long)B * E * plan.groups;
    const long long slots = (long long)sms * kBlocksPerSM;
    kernel<<<(int)(total < slots ? total : slots), kRingThreads, kRingSmem, st>>>(
        (const __nv_bfloat16*)pack, (const float*)queries, (const int*)sel, (float*)dots,
        (float*)csq, E, M0, D, N_pad, plan, total);
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

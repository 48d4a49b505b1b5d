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
// int8 (hop_int8_kernel<LANES, NC, UNIT>): bound by the same bytes. Written
// like the bf16 kernel it was held by its instruction stream (I2F at a
// quarter of the FMA rate, the query re-read from shared memory for every
// 16 bytes); sized for the 768-byte row alone (8-byte units, three a lane,
// four rows a warp, one block a query) it left lanes 16-31 of every warp
// without a load at the 128-byte row (16.3% of its byte bound in
// glove1.2m.bulk, PERF.md). Its plan now follows the row width, as B1's
// lanes do:
// - Lanes. A row of D codes is cut into units of 16 bytes, or of 8 where
//   those fill the lanes' slots better (D = 768: 96 units, three a lane,
//   against 48 chunks in 64 slots; 12-14% faster there,
//   scripts/hop_int8_ablate.py). LANES lanes share a row (its units
//   rounded up to a power of two, at most 32), 32 / LANES rows a warp-step,
//   each lane taking units sub, sub + LANES, ...: at D = 128 eight lanes a
//   row and four rows a step (every lane busy, 512 contiguous bytes a
//   step), at D = 768 all 32 lanes on one row. NC units a lane are held in
//   one pass (at most kI8RegUnits); longer rows run in passes.
// - Work. A query's E * M0 rows are cut into tasks of kI8Steps warp-steps.
//   A warp takes the tasks part, part + parts, ... of one query, parts
//   chosen so that the launch's warps fit the card at once where the batch
//   allows (four warps a query, two tasks each, at glove's hop), and holds
//   the bf16-rounded query at its units in registers, loaded once (once a
//   pass for rows in passes).
// - Loads before products. A task reads its rows' blocks from sel, then
//   issues all of its loads before the first product; the products run
//   with the steps innermost (one independent FMA chain a step).
// - Exact bytes without I2F: a byte's sign bit flipped (b + 128), byte_perm
//   places it in the low byte of 0x4B000000 (2^23 + b + 128), and one
//   subtraction of 2^23 + 128 leaves b.
// - Reduction. Each row's LANES partial sums are added over its own lanes
//   by halving exchanges: a lane sends half of the steps it still holds to
//   its partner and keeps the other half, so that at D = 128 a task's four
//   steps take 2 + 1 + 1 shuffles, not 3 rounds of 4 (the old plan took a
//   5-round warp sum a row), and each lane ends with the whole sum of a
//   step of its own; the task's 16 rows are then stored by distinct lanes,
//   64 contiguous bytes in one store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// int8: lanes mapped to (row, unit)
// ---------------------------------------------------------------------------

constexpr int kI8Threads = 128;
constexpr int kI8Warps = kI8Threads / 32;
// the units of a row a lane holds the query for in one pass: 32 lanes x 3
// units of 16 bytes cover a 1,536-byte row; longer rows run in passes
constexpr int kI8RegUnits = 3;

// warp-steps a task, all of whose loads are issued before the first product
// (two or eight read 5-7% slower at glove's hop and at D = 768, in a CUDA
// graph, scripts/hop_int8_ablate.py)
constexpr int kI8Steps = 4;

__host__ __device__ constexpr int log2_floor(int x) { return x > 1 ? 1 + log2_floor(x / 2) : 0; }

// lanes that share a row of `units`: a power of two, at most 32
int i8_lanes(int units) {
    int lanes = 1;
    while (lanes < units && lanes < 32) lanes *= 2;
    return lanes;
}

// One launch's plan (see the note above).
struct I8Plan {
    int unit;    // bytes a unit: 16, or 8 where those fill the lanes better
    int units;   // units of a row, D / unit
    int lanes;   // lanes that share a row
    int nc;      // units a lane takes of a row in one pass
    int passes;  // passes over a row, each with its own query slice
    int tasks;   // tasks of a query: its warp-steps, kI8Steps at a time
    int parts;   // warps a query, each taking tasks part, part + parts, ...
};

I8Plan i8_plan(int E, int M0, int D) {
    // the share of the lanes' unit slots that hold a unit of the row
    auto fill = [](int units) {
        const int lanes = i8_lanes(units), per_lane = (units + lanes - 1) / lanes;
        return (double)units / (lanes * per_lane);
    };
    I8Plan p;
    p.unit = fill(D / 8) > fill(D / 16) ? 8 : 16;
    p.units = D / p.unit;
    p.lanes = i8_lanes(p.units);
    const int per_lane = (p.units + p.lanes - 1) / p.lanes;
    p.nc = per_lane < kI8RegUnits ? per_lane : kI8RegUnits;
    p.passes = (per_lane + p.nc - 1) / p.nc;
    const int rows = 32 / p.lanes;
    const long long steps = ((long long)E * M0 + rows - 1) / rows;
    p.tasks = (int)((steps + kI8Steps - 1) / kI8Steps);
    p.parts = 1;
    return p;
}

// a unit of W 32-bit words: one 16- or 8-byte load through the read-only
// path, leaving L1 to the query and sel (each byte of a block is read once)
template <int W>
__device__ __forceinline__ void load_unit(const int8_t* p, uint32_t (&w)[W]) {
    if constexpr (W == 4) {
        asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "l"(p));
    } else {
        asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                     : "=r"(w[0]), "=r"(w[1])
                     : "l"(p));
    }
}

// LANES lanes a row, NC units a lane a pass, units of UNIT bytes (the plan's
// lanes, nc and unit).
template <int LANES, int NC, int UNIT>
__global__ void __launch_bounds__(kI8Threads)
hop_int8_kernel(const int8_t* __restrict__ codes, const float* __restrict__ queries,
                const int* __restrict__ sel, float* __restrict__ dots, int B, int E,
                int M0, int D, int N_pad, I8Plan plan) {
    constexpr int W = UNIT / 4;          // 32-bit words a unit
    constexpr int R = 32 / LANES;        // rows a warp-step
    constexpr int S = kI8Steps;          // warp-steps a task
    // after the reduction a lane holds V whole sums; the DUP lanes that
    // differ from it in the low bits of sub alone hold the same
    constexpr int V = S > LANES ? S / LANES : 1;
    constexpr int DUP = LANES > S ? LANES / S : 1;
    const int w = blockIdx.x * kI8Warps + (threadIdx.x >> 5);
    if (w >= B * plan.parts) return;
    const int b = w / plan.parts, part = w - b * plan.parts;
    const int lane = threadIdx.x & 31, my_row = lane / LANES, sub = lane & (LANES - 1);
    const int C = E * M0;
    const int* srow = sel + (long long)b * E;
    const float* qrow = queries + (long long)b * D;
    float* out = dots + (long long)b * C;

    // the bf16-rounded query values of the lane's units of one pass
    float q[NC][UNIT];
    auto load_slice = [&](int pass) {
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const int c = (pass * NC + k) * LANES + sub;
            const float4* src = reinterpret_cast<const float4*>(qrow + c * UNIT);
#pragma unroll
            for (int h = 0; h < W; ++h) {
                const float4 v = c < plan.units ? __ldg(src + h) : make_float4(0.f, 0.f, 0.f, 0.f);
                q[k][4 * h] = __bfloat162float(__float2bfloat16_rn(v.x));
                q[k][4 * h + 1] = __bfloat162float(__float2bfloat16_rn(v.y));
                q[k][4 * h + 2] = __bfloat162float(__float2bfloat16_rn(v.z));
                q[k][4 * h + 3] = __bfloat162float(__float2bfloat16_rn(v.w));
            }
        }
    };
    if (plan.passes == 1) load_slice(0);

    for (int t = part; t < plan.tasks; t += plan.parts) {
        // the pack row (block row * M0 + m) of the lane's row in each step:
        // row r = (t * S + u) * R + my_row of the query's E * M0, in its
        // block e = r / M0 at m = r % M0 (stepped, one division a task); -1
        // past the query's rows
        int r = t * S * R + my_row;
        int e = r / M0, m = r - e * M0;
        long long at[S];
#pragma unroll
        for (int u = 0; u < S; ++u) {
            at[u] = r < C ? clamp_row(__ldg(srow + e), N_pad) * M0 + m : -1;
            r += R;
            for (m += R; m >= M0; m -= M0) ++e;
        }
        float acc[S];
#pragma unroll
        for (int u = 0; u < S; ++u) acc[u] = 0.f;
        for (int pass = 0; pass < plan.passes; ++pass) {
            if (plan.passes > 1) load_slice(pass);
            // every load of the task first (zero bytes past the row or the
            // query's rows: 0 after the conversion), then the products
            uint32_t raw[S][NC][W];
#pragma unroll
            for (int u = 0; u < S; ++u)
#pragma unroll
                for (int k = 0; k < NC; ++k) {
                    const int c = (pass * NC + k) * LANES + sub;
                    if (at[u] >= 0 && c < plan.units) {
                        load_unit<W>(codes + at[u] * D + c * UNIT, raw[u][k]);
                    } else {
#pragma unroll
                        for (int h = 0; h < W; ++h) raw[u][k][h] = 0u;
                    }
                }
            // the steps innermost: S independent FMA chains
#pragma unroll
            for (int k = 0; k < NC; ++k)
#pragma unroll
                for (int h = 0; h < W; ++h)
#pragma unroll
                    for (int u = 0; u < S; ++u) {
                        const uint32_t word = raw[u][k][h] ^ 0x80808080u;
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const float v = __fsub_rn(
                                __int_as_float(__byte_perm(word, 0x4B000000u, 0x7650 + j)),
                                8388736.f);
                            acc[u] = fmaf(q[k][4 * h + j], v, acc[u]);
                        }
                    }
        }
        // halving exchanges over the row's lanes, largest offset first: a
        // lane whose bit `off` is set keeps the upper half of the steps it
        // holds and sends the lower half, its partner the reverse; once a
        // lane holds one step the rounds left add the partners' sums
        int base = 0;   // the first of the steps the lane holds
#pragma unroll
        for (int i = 0; i < log2_floor(LANES); ++i) {
            const int off = LANES >> (i + 1), half = S >> (i + 1);
            if (half > 0) {
                const bool upper = (sub & off) != 0;
#pragma unroll
                for (int j = 0; j < half; ++j) {
                    const float send = upper ? acc[j] : acc[half + j];
                    const float keep = upper ? acc[half + j] : acc[j];
                    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
                }
                if (upper) base += half;
            } else {
                acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
            }
        }
        // each of the task's S * R rows from one lane: a coalesced store
        if ((sub & (DUP - 1)) == 0) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const int row = (t * S + base + j) * R + my_row;
                if (row < C) out[row] = acc[j];
            }
        }
    }
}

using I8Kernel = void (*)(const int8_t*, const float*, const int*, float*, int, int, int, int,
                          int, I8Plan);
constexpr int kI8Kernels = 9;

// the instantiation of a plan, and its index in the entry point's caches
int i8_kernel(const I8Plan& p, I8Kernel* kernel) {
    switch (p.lanes) {
        case 1: *kernel = hop_int8_kernel<1, 1, 16>; return 0;
        case 2: *kernel = hop_int8_kernel<2, 1, 16>; return 1;
        case 4: *kernel = hop_int8_kernel<4, 1, 16>; return 2;
        case 8: *kernel = hop_int8_kernel<8, 1, 16>; return 3;
        case 16: *kernel = hop_int8_kernel<16, 1, 16>; return 4;
    }
    // 8-byte units fill the lanes better only where a lane takes three or more
    if (p.unit == 8) { *kernel = hop_int8_kernel<32, kI8RegUnits, 8>; return 5; }
    if (p.nc == 1) { *kernel = hop_int8_kernel<32, 1, 16>; return 6; }
    if (p.nc == 2) { *kernel = hop_int8_kernel<32, 2, 16>; return 7; }
    *kernel = hop_int8_kernel<32, kI8RegUnits, 16>;
    return 8;
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
    if (B <= 0 || E <= 0 || M0 <= 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 0) {  // every sum is empty
        cudaMemsetAsync(dots, 0, (size_t)B * E * M0 * sizeof(float), st);
        return (int)cudaGetLastError();
    }
    I8Plan plan = i8_plan(E, M0, D);
    I8Kernel kernel;
    const int ix = i8_kernel(plan, &kernel);
    // the warps of this instantiation the card holds at once, looked up
    // once per device
    int dev = 0;
    cudaGetDevice(&dev);
    static int resident[kI8Kernels][64];
    int warps = dev < 64 ? resident[ix][dev] : 0;
    if (!warps) {
        int sms = 0, blocks = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kI8Threads, 0);
        warps = sms * blocks * kI8Warps > 0 ? sms * blocks * kI8Warps : 1;
        if (dev < 64) resident[ix][dev] = warps;
    }
    // as many warps a query as let the batch's warps fit the card at once,
    // at most one a task
    const int fit = warps / B;
    plan.parts = fit < 1 ? 1 : fit < plan.tasks ? fit : plan.tasks;
    const long long total = (long long)B * plan.parts;
    kernel<<<(int)((total + kI8Warps - 1) / kI8Warps), kI8Threads, 0, st>>>(
        (const int8_t*)codes, (const float*)queries, (const int*)sel, (float*)dots, B, E, M0,
        D, N_pad, plan);
    return (int)cudaGetLastError();
}

// lanes that share a row of D int8 codes in hop_score_int8's plan: below 32
// a warp-step scores several rows (the narrow plan)
extern "C" int hop_score_int8_lanes(int D) { return D < 16 ? 1 : i8_plan(1, 1, D).lanes; }

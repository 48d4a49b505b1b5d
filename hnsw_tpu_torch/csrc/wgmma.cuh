// The Hopper mainloop of the redesigned scan kernels and the matmul floors:
// TMA loads through an mbarrier ring, wgmma on warpgroups, the query block
// resident in shared memory, and an epilogue that works on the accumulator
// registers in place.
//
// Used by csrc/scan.cu (bucket_bank_wgmma_kernel, the bf16 and int8 bucket
// banks, and packed_bank_wgmma_kernel, the packed int8 bank), by
// csrc/sweep.cu (sweep_wgmma_kernel, the bf16 and int8 sweeps: the ring, the
// producer and the wgmma of this file, with a consumer loop of its own in
// which the two consumers take whole tiles in turn) and by every
// matmul floor of csrc/probes.cu (last_tile_kernel: matmul_only and
// matmul_min; colsum_kernel: mm_only, mm_only_nt and, with an MN-major corpus
// operand, mm_only_kmajor). It replaced, for all of them, a loop of
// warp-level MMA instructions: 8 warps fed through registers, one 128-byte K
// chunk staged between two __syncthreads, the query block staged again for
// every corpus tile, and each finished 64 x 128 product tile written to
// shared memory as f32 for the epilogue. That loop ran at 8-9x its
// tensor-core bound on the H100, 1.6-2.0x slower than cuBLAS.
//
// Bound on the H100: the tensor cores, 2*B*N*D operations (989e12/s bf16,
// 1979e12/s s8). What holds this design below that (PERF.md): a block tile
// of 64 queries x 128 corpus rows as two m64n64 wgmma streams reads 32 KB of
// shared memory per 128-byte chunk (each consumer reads the query chunk and
// its half of the corpus chunk), as long as the products take at the peak
// rate; it reached about 41% of the peak on both types. The corpus stream
// from L2 is not the limit: a cluster of two blocks sharing each corpus chunk
// by TMA multicast halved it and moved no time.
//
// Design. A block of 384 threads owns 64 queries and walks the 128-row corpus
// tiles [t_begin, t_end) of one split, in increasing order:
// - warpgroup 0 is the producer: one thread issues cp.async.bulk.tensor loads
//   with the 128-byte swizzle. The query block [64, row_bytes] is loaded once
//   (row_bytes / 128 chunks of [64][128] bytes), the corpus tile chunk by chunk
//   ([128][128] bytes) into a ring of `stages` buffers guarded by full (TMA
//   bytes arrived) and empty (every consumer warp done) mbarriers. TMA fills
//   query rows >= B with zeros. setmaxnreg gives its registers to the
//   consumers.
// - warpgroups 1 and 2 are the consumers. Consumer w computes the products of
//   the 64 queries with corpus columns [64w, 64w + 64) of each tile: four
//   wgmma m64n64 (k16 bf16 -> f32, or k32 s8 -> s32) per 128-byte chunk, A and
//   B read from shared memory through 128-byte-swizzle descriptors (K-major;
//   B MN-major with VT, below).
//   Each consumer keeps two accumulator sets: the epilogue of tile t runs
//   after tile t+1's first three chunks are issued, on the registers of tile
//   t where they lie. In the wgmma accumulator layout thread (warp v, lane l)
//   owns the rows 16v + l/4 (+ 8) and the columns 64w + 8j + 2(l%4) (+ 1),
//   j < 8, on every tile, so per-(query, column) state lives in registers
//   beside the accumulators. No block-wide barrier after the set-up. ptxas
//   still waits for the in-flight group before the epilogue's first read
//   (info C7517), so the other consumer, not the same one, fills the tensor
//   cores while an epilogue runs. consume_sum is the variant without an
//   epilogue: one accumulator set carried across all the tiles of the split
//   (a column sum), with no per-tile drain.
// - VT (bf16 only): the corpus is read as vT [D, N], N contiguous. A chunk is
//   64 K rows of the tile's 128 corpus rows, loaded as one box of 64 x 64 per
//   consumer half (8 KB each, so a stage is still 16 KB), and the consumers'
//   wgmma read B MN-major (imm-trans-b = 1; see desc_sw128).
// Shared memory: the query block (row_bytes * 64: 96 KB bf16 or 48 KB s8 at
// D = 768) plus stages * 16 KB of ring, at most 8 stages and at least 3, plus
// barriers, plus the `extra` bytes a kernel asks plan() for, placed after the
// barriers (the sweeps: 1 KB), within the 227 KB a block may take (D = 768: 8
// stages, 225 KB bf16, 177 KB s8; the sweeps keep 8). A query block that
// leaves no room for 3 stages (row_bytes > 2,816) is instead streamed through
// the ring beside each corpus chunk (8 KB more per stage). Above 48 KB the launch needs
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
// ...), which the C entries call. The tensor maps are encoded on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so no
// -lcuda) and passed as __grid_constant__ kernel parameters.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BM = 64;                   // queries per block (the wgmma M)
constexpr int BN = 128;                  // corpus rows per tile
constexpr int KB = 128;                  // bytes of K per chunk: one swizzle row
constexpr int WN = 64;                   // corpus columns per consumer (the wgmma N)
constexpr int kConsumers = BN / WN;      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kAcc = BM * WN / 128;      // accumulator registers per thread
constexpr int kQChunk = BM * KB;         // bytes of one query chunk
constexpr int kVChunk = BN * KB;         // bytes of one corpus chunk
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;         // per block on the H100
constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 128 * 40 + 256 * 232 <= 65,536

// ---------------------------------------------------------------------------
// host: the shared-memory plan and the tensor maps
// ---------------------------------------------------------------------------

struct Plan {
    int stages;
    int q_resident;
    int smem;       // dynamic shared memory bytes, with 1 KB for the alignment
};

inline Plan plan(int row_bytes, int extra = 0) {
    const int nk = row_bytes / KB;
    const int avail = kSmemMax - 1024 - kBarBytes - extra;
    Plan p;
    p.q_resident = nk * kQChunk + kMinStages * kVChunk <= avail;
    const int q_bytes = p.q_resident ? nk * kQChunk : 0;
    const int stage_bytes = kVChunk + (p.q_resident ? 0 : kQChunk);
    p.stages = (avail - q_bytes) / stage_bytes;
    if (p.stages > kMaxStages) p.stages = kMaxStages;
    p.smem = 1024 + q_bytes + p.stages * stage_bytes + kBarBytes + extra;
    return p;
}

// A map of `rows` rows of row_bytes bytes (s8 or bf16 elements), read in
// boxes of box_rows rows x 128 bytes with the 128-byte swizzle; rows past the
// end read as zeros. A row is a query or corpus row, or for vT [D, N] one K
// row of N corpus elements (box_rows = 64 K rows, the box 64 corpus rows
// wide). Returns a cudaError_t code.
inline int encode_rows(CUtensorMap* map, const void* base, int row_bytes, long long rows,
                       int box_rows, bool int8) {
    using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                        cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorNotSupported;
        encode = reinterpret_cast<Encode>(fn);
    }
    const int esize = int8 ? 1 : 2;
    const cuuint64_t dims[2] = {(cuuint64_t)(row_bytes / esize), (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(KB / esize), (cuuint32_t)box_rows};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult res = encode(
        map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
        const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c_inner, int c_row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_row)
        : "memory");
}

// An operand tile as TMA writes it with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1,024 bytes apart (SBO), LBO unused (1); the base is
// 1,024-byte aligned.
// - K-major (queries, and the corpus as [N, D]): a row is one M or N index,
//   its 128 bytes run along K. A 32-byte k step adds 2 to the address field.
// - MN-major (the corpus as vT [D, N], read with imm-trans-b = 1): a row is
//   one K index holding 64 N elements. The descriptor fields are the same
//   (cute's make_gmma_desc<Major::MN>: SBO is the stride between 8-row K
//   groups, LBO the stride between 64-element N blocks, of which an m64n64
//   B has one), but a k16 step spans 16 rows: 2,048 bytes, 128 in the
//   address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators at this point of the program: reads after a wait
// cannot move above it, writes cannot sink below a later issue.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_ACC_OPERANDS(C)                                                                     \
    C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]),  \
        C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]),        \
        C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]),        \
        C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define WG_ACC_LIST                                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)

// d (+)= A[64 x k16] B[k16 x 64], bf16 -> f32; scale_d = 0 overwrites d.
// TRANS_B reads B MN-major (imm-trans-b = 1).
template <bool TRANS_B = false>
__device__ __forceinline__ void mma(float (&d)[kAcc], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC_LIST
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WG_ACC_OPERANDS(WG_F)
        : "l"(a), "l"(b), "r"(scale_d), "n"((int)TRANS_B));
}

// d (+)= A[64 x k32] B[k32 x 64], s8 -> exact s32
template <bool TRANS_B = false>
__device__ __forceinline__ void mma(int (&d)[kAcc], uint64_t a, uint64_t b, int scale_d) {
    static_assert(!TRANS_B, "wgmma transposes 16-bit operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_ACC_LIST
        ", %32, %33, p;\n}\n"
        : WG_ACC_OPERANDS(WG_R)
        : "l"(a), "l"(b), "r"(scale_d));
}

#undef WG_ACC_OPERANDS
#undef WG_ACC_LIST
#undef WG_F
#undef WG_R

// ---------------------------------------------------------------------------
// the pipeline
// ---------------------------------------------------------------------------

struct Ring {
    uint32_t base;      // query chunks (resident: chunk kc; streamed: stage s)
    uint32_t v_base;    // corpus stages
    uint32_t full, empty, qbar;
    int nk, stages, q_resident;
};

// All threads: carve the dynamic shared memory and initialise the barriers.
// empty_count: the warp arrivals that free a stage (every consumer warp by
// default; a kernel whose chunks each have one consumer passes 4).
__device__ __forceinline__ Ring setup(uint8_t* smem_raw, int nk, int stages, int q_resident,
                                      int empty_count = kConsumers * 4) {
    Ring r;
    r.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    r.v_base = r.base + (q_resident ? nk : stages) * kQChunk;
    r.full = r.v_base + stages * kVChunk;
    r.empty = r.full + 8 * kMaxStages;
    r.qbar = r.empty + 8 * kMaxStages;
    r.nk = nk;
    r.stages = stages;
    r.q_resident = q_resident;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(r.full + 8 * s, 1);
            mbar_init(r.empty + 8 * s, empty_count);
        }
        mbar_init(r.qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return r;
}

__device__ __forceinline__ void producer_regs() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// One thread of the producer warpgroup: the query block, then every chunk of
// the tiles [t_begin, t_end). chunk_elems = 128 bytes in elements (with VT
// also the K rows of a chunk).
template <bool VT = false>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* qmap,
                                        const CUtensorMap* vmap, int q0, int t_begin, int t_end,
                                        int chunk_elems) {
    if (t_end <= t_begin) return;
    if (r.q_resident) {
        mbar_expect_tx(r.qbar, r.nk * kQChunk);
        for (int kc = 0; kc < r.nk; ++kc)
            tma_load(r.base + kc * kQChunk, qmap, r.qbar, kc * chunk_elems, q0);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
        for (int kc = 0; kc < r.nk; ++kc) {
            mbar_wait(r.empty + 8 * stage, phase ^ 1);
            const uint32_t full = r.full + 8 * stage;
            mbar_expect_tx(full, kVChunk + (r.q_resident ? 0 : kQChunk));
            const uint32_t dst = r.v_base + stage * kVChunk;
            if constexpr (VT) {
                // vT: one 64 x 64 box per consumer half, corpus rows 64h..
                for (int h = 0; h < kConsumers; ++h)
                    tma_load(dst + h * WN * KB, vmap, full, t * BN + h * WN, kc * chunk_elems);
            } else {
                tma_load(dst, vmap, full, kc * chunk_elems, t * BN);
            }
            if (!r.q_resident)
                tma_load(r.base + stage * kQChunk, qmap, full, kc * chunk_elems, q0);
            if (++stage == r.stages) {
                stage = 0;
                phase ^= 1;
            }
        }
    }
}

// The chunk of tile t+1 after whose issue tile t's epilogue runs: chunks
// 0..kEpilogueChunk are queued on the tensor cores when it starts.
constexpr int kEpilogueChunk = 2;

// A consumer's place in the ring: the next stage and its phase, the oldest
// stage it has not released, and how many it holds.
struct Cursor {
    int stage = 0, oldest = 0, held = 0;
    uint32_t phase = 0;
};

// Free every stage but the newest `keep`, oldest first.
__device__ __forceinline__ void release(const Ring& r, Cursor& c, int keep) {
    __syncwarp();
    for (; c.held > keep; --c.held) {
        if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * c.oldest);
        if (++c.oldest == r.stages) c.oldest = 0;
    }
}

// Wait for the next stage and queue chunk kc of it (the query chunk with this
// consumer's half of the corpus chunk) on acc as one wgmma group; `fresh`
// overwrites acc (scale_d = 0 on the first k step).
template <bool VT, typename Acc>
__device__ __forceinline__ void mma_chunk(const Ring& r, Cursor& c, Acc (&acc)[kAcc], int kc,
                                            bool fresh) {
    const int w = threadIdx.x / 128 - 1;
    mbar_wait(r.full + 8 * c.stage, c.phase);
    const uint64_t da = desc_sw128(r.base + (r.q_resident ? kc : c.stage) * kQChunk);
    const uint64_t db = desc_sw128(r.v_base + c.stage * kVChunk + w * WN * KB);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks)
        mma<VT>(acc, da + 2 * ks, db + (VT ? 128 : 2) * ks, !fresh || ks != 0);
    wgmma_commit();
    ++c.held;
    if (++c.stage == r.stages) {
        c.stage = 0;
        c.phase ^= 1;
    }
}

// A consumer warpgroup: the products of its 64 columns of every tile in
// [t_begin, t_end), in order. epilogue(acc, t) runs on tile t's finished
// accumulators after tile t+1's first chunks are issued (the last tile's
// after the loop); prefetch(t) runs later in tile t, after that epilogue.
// Every tile ends with all its groups retired (wait_group 0), so the
// accumulator set the epilogue reads is never in flight, and no read of a
// set is ever placed between its wgmma and their wait; ptxas nonetheless
// waits for the queued chunks before the epilogue's first read (C7517).
template <typename Acc, typename Prefetch, typename Epilogue>
__device__ __forceinline__ void consume(const Ring& r, int t_begin, int t_end,
                                        Prefetch&& prefetch, Epilogue&& epilogue) {
    if (t_end <= t_begin) return;
    const int epi_kc = kEpilogueChunk < r.nk - 1 ? kEpilogueChunk : r.nk - 1;
    const int prefetch_kc = r.nk / 2 > epi_kc ? r.nk / 2 : epi_kc;
    if (r.q_resident) mbar_wait(r.qbar, 0);

    Acc acc0[kAcc], acc1[kAcc];
    Cursor c;

    // tile t into acc; prev holds tile t - 1 when t > t_begin
    auto tile = [&](auto& acc, auto& prev, int t) {
        for (int kc = 0; kc < r.nk; ++kc) {
            mma_chunk<false>(r, c, acc, kc, kc == 0);
            if (kc == epi_kc && t > t_begin) epilogue(prev, t - 1);
            if (kc == prefetch_kc) prefetch(t);
            if (kc >= epi_kc) {
                // every group but the newest is complete: free their stages
                wgmma_wait<1>();
                release(r, c, 1);
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        release(r, c, 0);
    };

    int t = t_begin;
    for (; t + 1 < t_end; t += 2) {
        tile(acc0, acc1, t);
        tile(acc1, acc0, t + 1);
    }
    if (t < t_end) tile(acc0, acc1, t);
    if ((t_end - t_begin) & 1)
        epilogue(acc0, t_end - 1);
    else
        epilogue(acc1, t_end - 1);
}

// A consumer warpgroup without an epilogue: acc = the sum over the tiles
// [t_begin, t_end) of its 64 columns' products, i.e. the wgmma accumulation
// carried across tiles in one accumulator set. scale_d = 0 on the split's
// first chunk only; each chunk frees the stage of the one before it
// (wait_group 1), and one wait_group 0 at the end leaves acc readable.
// acc is zero for an empty range.
template <bool VT, typename Acc>
__device__ __forceinline__ void consume_sum(const Ring& r, int t_begin, int t_end,
                                            Acc (&acc)[kAcc]) {
    if (t_end <= t_begin) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = 0;
        return;
    }
    if (r.q_resident) mbar_wait(r.qbar, 0);
    Cursor c;
    for (int t = t_begin; t < t_end; ++t)
        for (int kc = 0; kc < r.nk; ++kc) {
            mma_chunk<VT>(r, c, acc, kc, t == t_begin && kc == 0);
            wgmma_wait<1>();
            release(r, c, 1);
        }
    wgmma_wait<0>();
    fence_acc(acc);
    release(r, c, 0);
}

// The accumulator coordinates of this consumer thread: register 4j + 2h + e
// holds (row0 + 8h, col0 + 8j + e).
struct Frag {
    int row0, col0;
};

__device__ __forceinline__ Frag frag() {
    const int lt = threadIdx.x & 127, lane = lt & 31;
    const int w = threadIdx.x / 128 - 1;
    return Frag{(lt >> 5) * 16 + (lane >> 2), w * WN + 2 * (lane & 3)};
}

}  // namespace wg

// Fused flat scans with bucketed best-two selection (bf16, int8, packed int8).
// All three run the Hopper mainloop of wgmma.cuh (TMA ring, wgmma, resident
// query block), as do the sweeps of sweep.cu and the floors of probes.cu.
//
// Replaces the TPU kernels hnsw_tpu/ops/pallas_scan.py::pallas_bucket_topk
// (_make_kernel_bucketed), ::pallas_int8_bucket_topk
// (_make_kernel_int8_bucketed) and ::pallas_int8_packed_topk
// (_make_kernel_int8_packed).
//
// Contract. For every query q and corpus row r < n the kernel forms the dot
// product on the tensor cores (bf16 x bf16 -> f32, or s8 x s8 -> s32 then
// f32) and a key that orders rows like the metric does for that query:
//   bf16: cosine -dot*vkey (vkey = 1/|v|), euclidean vkey - 2*dot
//         (vkey = |v|^2), dot -dot
//   int8: cosine -dot*vkey (vkey = vscale/|v|), euclidean
//         vkey - 2*qscale*vscale*dot (vkey = |v|^2), dot -dot*vkey
//         (vkey = vscale)
//   packed int8 (cosine, dot): dot*nvkey + PACK_BIAS with nvkey the negated
//         int8 vkey, a positive float whose int32 bits order like it; the low
//         gbits bits are replaced by the row's 128-row group within its
//         nt-row tile, so each key is unique in its tile and carries its row.
// Rows >= n get the key BIG (packed: 0x7F000000). Bucket c holds the rows r
// with r mod 128 == c; for each (query, bucket) the kernel keeps the best two
// (key, row) pairs and writes them as a bank [B, 256]: best keys in
// [:, :128], second keys in [:, 128:]. The caller takes the top-k of the
// bank.
//
// Bound on the H100: tensor-core operations, 2*B*N_pad*D of them, plus a
// per-element epilogue (the key and the best-two update). A block owns 64
// queries and walks the 128-row corpus tiles of one split of the corpus, in
// increasing order. A 128-row tile holds exactly one row of each bucket, so
// the running best two of each (query, bucket) pair are updated by one insert
// per tile; they live in registers. The TPU's sequential corpus-tile axis
// becomes the loop inside the block plus S splits across blocks; each split
// writes a partial bank and bucket_merge folds the splits in order with the
// reference's _merge_pair2 rule, so an earlier row wins a tie as it does
// there.
//
// The bucket banks (bucket_bank_wgmma_kernel<INT8, METRIC>, one template for
// bf16 and int8) run the mainloop of wgmma.cuh. Their predecessor, a loop of
// warp-level MMA fed through registers (on the H100 at B = 4096: bf16 6.672
// ms over the 31,744-row pack, int8 2.710 ms over 32,768 rows, against
// tensor-core bounds of 0.199 and 0.099 ms), spent most of its time in the
// epilogue: 4 registers per pair (255
// registers, 900 spill bytes in int8), each product read back from a
// shared-memory copy of the tile, a run-time metric branch per element, and
// one block per SM with nothing to hide the epilogue behind. Now two consumer
// warpgroups each own 64 buckets (m64n64 wgmma: bf16 k16 into f32, or s8 k32
// into exact s32; 32 pairs a thread), the bank is kept in the accumulator
// layout with both kept rows of a pair as 16-bit tile indices in one
// register (3 registers a pair), keys are formed from the accumulator
// registers where they lie, the metric is a template parameter, and each
// tile's insert runs once the next tile's first products are queued (two
// accumulator sets; ptxas waits for them before the insert, and the other
// consumer keeps the tensor cores busy). The vkey values of the thread's 16
// columns (and for int8 euclidean their vscale) are loaded half a tile before
// they are needed, and the int8 euclidean 2*qscale of the thread's two query
// rows once. Keys are bit for bit those of the plain versions: bf16 as
// listed above; int8 from the exact s32 dot converted to f32 (exact below
// 2^24), then __fmul_rn(-dot, vkey), or for euclidean
// __fsub_rn(vkey, __fmul_rn(__fmul_rn(2*qscale, vscale), dot)). Ties follow
// insert2_packed's < and <=, tiles in order. A register-light bank alone, on the
// old loop, took the bf16 kernel from 6.5 to 1.6 ms; the new loop to 0.5
// (PERF.md). The int8 epilogue has the shorter loop of the two to hide
// behind (6 chunks a tile at D = 768, not 12) and converts each s32 dot to
// f32 at a quarter of the FMA rate.
//
// The packed kernel (packed_bank_wgmma_kernel) runs the same loop, with the
// same consumer layout: per (query, bucket) it keeps the two smallest packed
// int32 keys over the nt/128 sub-tiles of each nt-row tile, 2 registers a
// pair. They are unique within the tile, so that part is order-free and the
// insert is branch-free: p2 = min(p2, max(p1, p)), p1 = min(p1, p). The
// nvkey values of the thread's 16 columns are loaded half a tile early, as
// the int8 bank's vkey. At each nt-row tile boundary (a branch uniform over
// the tile, outside the per-element loop) it folds them with _merge_pair2,
// in tile order, into the split's bank, comparing the keys with the group
// bits cleared as the reference's decode does. That bank cannot stay in
// registers (3 more a pair would spill) and lives in shared memory beside
// the ring: 12 bytes a pair, the two packed keys with their group bits and
// the two nt-row tiles within the split as 16-bit halves, 96 KB a block, so
// the int8 ring keeps 5 stages at D = 768. Each (query, bucket) has one
// owning thread, so the bank needs no synchronisation; it is decoded and
// written once at the end of the split. Folding into the partial-bank buffer
// in global memory instead (each fold a read-modify-write of 128 KB a block
// through L2, all blocks at once) cost 0.08 ms of 0.36 on the H100 (PERF.md).
// Splits are aligned to nt-row tiles. Its keys are one exact int32 dot, one
// __fmul_rn and one __fadd_rn, bit for bit those of the plain version.

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int BN = wg::BN;
constexpr float BIG = 1e30f;
enum { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };
constexpr int INVALID_PACKED = 0x7F000000;   // sorts after every biased key
constexpr float PACK_BIAS = 16384.f;

// _merge_pair2: smallest two of {a1, a2, b1, b2} (a1 <= a2, b1 <= b2), with
// a (the earlier rows) winning ties against b on the first comparison.
__device__ __forceinline__ void merge2(float& a1, int& ai1, float& a2, int& ai2,
                                       float b1, int bi1, float b2, int bi2) {
    const bool a_first = a1 <= b1;
    const float n1 = a_first ? a1 : b1;
    const int ni1 = a_first ? ai1 : bi1;
    const float mid = a_first ? b1 : a1;
    const int mi = a_first ? bi1 : ai1;
    const float o2 = fminf(a2, b2);
    const int oi2 = a2 <= b2 ? ai2 : bi2;
    a1 = n1; ai1 = ni1;
    a2 = mid <= o2 ? mid : o2;
    ai2 = mid <= o2 ? mi : oi2;
}

// The reference's _merge_pair2 for one incoming candidate (x, tile index ti)
// whose row is later than both kept rows: a tie with the best keeps the
// earlier best (<), a tie with the second takes the later row (<=). The two
// kept rows are 16-bit tile indices within the split, packed in one
// register: best in the low half, second in the high.
__device__ __forceinline__ void insert2_packed(float x, uint32_t ti, float& d1, float& d2,
                                               uint32_t& rr) {
    const bool b1 = x < d1, b2 = x <= d2;
    const uint32_t rr1 = __byte_perm(rr, ti, 0x1054);   // (ti, old best)
    const uint32_t rr2 = __byte_perm(rr, ti, 0x5410);   // (old best, ti)
    d2 = b1 ? d1 : (b2 ? x : d2);
    d1 = b1 ? x : d1;
    rr = b1 ? rr1 : (b2 ? rr2 : rr);
}

constexpr uint32_t NO_TILE = 0xFFFFu;

// element e of a column pair
__device__ __forceinline__ float pick(float2 v, int e) { return e ? v.y : v.x; }

// The bf16 (INT8 = false) and int8 banks on the Hopper mainloop of
// wgmma.cuh. Consumer thread state: 32 (query, bucket) pairs, each two f32
// keys and one register holding both kept rows as 16-bit tile indices (the
// bucket is the column, fixed by the register's position), so 3 registers a
// pair; 32 accumulators per set, two sets; the 16 vkey values of the
// thread's columns of the next tile to finish, and for int8 euclidean their
// 16 vscale values and the thread's two 2*qscale. vscale and qscale are read
// only for int8 euclidean.
template <bool INT8, int METRIC>
__global__ void __launch_bounds__(wg::kThreads, 1)
bucket_bank_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                         __grid_constant__ const CUtensorMap vmap, const float* __restrict__ vkey,
                         const float* __restrict__ vscale, const float* __restrict__ qscale,
                         float* __restrict__ part_d, int* __restrict__ part_r, int B, int N_pad,
                         int n, int nk, int stages, int q_resident, int splits) {
    using Acc = typename std::conditional<INT8, int, float>::type;
    constexpr bool kScales = INT8 && METRIC == EUCLIDEAN;
    extern __shared__ uint8_t smem_raw[];
    const wg::Ring ring = wg::setup(smem_raw, nk, stages, q_resident);
    const int q0 = blockIdx.x * wg::BM, split = blockIdx.y;
    const int ntiles_all = N_pad / wg::BN;
    const int t_begin = (int)((long long)split * ntiles_all / splits);
    const int t_end = (int)((long long)(split + 1) * ntiles_all / splits);

    if (threadIdx.x < 128) {
        wg::producer_regs();
        if (threadIdx.x == 0)
            wg::produce(ring, &qmap, &vmap, q0, t_begin, t_end, INT8 ? wg::KB : wg::KB / 2);
    } else {
        wg::consumer_regs();
        const wg::Frag f = wg::frag();
        float d1[wg::kAcc], d2[wg::kAcc];
        uint32_t rr[wg::kAcc];
#pragma unroll
        for (int i = 0; i < wg::kAcc; ++i) { d1[i] = BIG; d2[i] = BIG; rr[i] = 0xFFFFFFFFu; }
        float2 vk[wg::WN / 8];
        float2 vs[kScales ? wg::WN / 8 : 1];
        float qs2[2];
        if constexpr (kScales) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int q = q0 + f.row0 + 8 * h;
                qs2[h] = q < B ? 2.f * qscale[q] : 0.f;
            }
        }

        wg::consume<Acc>(ring, t_begin, t_end,
                         [&](int tile) {
            if constexpr (INT8 || METRIC != DOT) {
#pragma unroll
                for (int j = 0; j < wg::WN / 8; ++j)
                    vk[j] = __ldg(reinterpret_cast<const float2*>(vkey + tile * wg::BN +
                                                                  f.col0 + 8 * j));
            }
            if constexpr (kScales) {
#pragma unroll
                for (int j = 0; j < wg::WN / 8; ++j)
                    vs[j] = __ldg(reinterpret_cast<const float2*>(vscale + tile * wg::BN +
                                                                  f.col0 + 8 * j));
            }
        },
                         [&](auto& acc, int tile) {
            const uint32_t ti = (uint32_t)(tile - t_begin);
            const int lim = n - tile * wg::BN - f.col0;   // column offsets below lim are live
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = 4 * j + 2 * h + e;
                        // an s32 dot converts exactly below 2^24 (D <= 1040)
                        const float dot = static_cast<float>(acc[i]);
                        float key = -dot;   // bf16 dot
                        if constexpr (kScales)
                            key = __fsub_rn(pick(vk[j], e),
                                            __fmul_rn(__fmul_rn(qs2[h], pick(vs[j], e)), dot));
                        else if constexpr (INT8 || METRIC == COSINE)
                            key = __fmul_rn(-dot, pick(vk[j], e));
                        else if constexpr (METRIC == EUCLIDEAN)
                            key = pick(vk[j], e) - 2.f * dot;
                        insert2_packed(8 * j + e < lim ? key : BIG, ti, d1[i], d2[i], rr[i]);
                    }
        });

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = q0 + f.row0 + 8 * h;
            if (q >= B) continue;
            const long long base = ((long long)split * B + q) * (2 * wg::BN);
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j) {
                const int c = f.col0 + 8 * j, i = 4 * j + 2 * h;
                int r1[2], r2[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const uint32_t lo = rr[i + e] & NO_TILE, hi = rr[i + e] >> 16;
                    r1[e] = lo == NO_TILE ? -1 : (t_begin + (int)lo) * wg::BN + c + e;
                    r2[e] = hi == NO_TILE ? -1 : (t_begin + (int)hi) * wg::BN + c + e;
                }
                *reinterpret_cast<float2*>(part_d + base + c) = make_float2(d1[i], d1[i + 1]);
                *reinterpret_cast<float2*>(part_d + base + wg::BN + c) =
                    make_float2(d2[i], d2[i + 1]);
                *reinterpret_cast<int2*>(part_r + base + c) = make_int2(r1[0], r1[1]);
                *reinterpret_cast<int2*>(part_r + base + wg::BN + c) = make_int2(r2[0], r2[1]);
            }
        }
    }
}

// A bank: tensor maps, shared memory, launch. Every split must hold fewer
// than 65,536 tiles (16-bit tile indices; the wrapper plans so).
template <bool INT8>
int launch_bank(const void* vectors, const void* vkey, const void* vscale, const void* queries,
                const void* qscale, void* part_d, void* part_r, int B, int N_pad, int D, int n,
                int metric, int splits, cudaStream_t stream) {
    const int ntiles = N_pad / wg::BN;
    if ((ntiles + splits - 1) / splits >= (int)NO_TILE + 1) return (int)cudaErrorInvalidValue;
    const int row_bytes = INT8 ? D : 2 * D;
    const wg::Plan p = wg::plan(row_bytes);
    CUtensorMap qmap, vmap;
    int err = wg::encode_rows(&qmap, queries, row_bytes, B, wg::BM, INT8);
    if (err == 0) err = wg::encode_rows(&vmap, vectors, row_bytes, N_pad, wg::BN, INT8);
    if (err != 0) return err;
    auto kernel = metric == COSINE      ? bucket_bank_wgmma_kernel<INT8, COSINE>
                  : metric == EUCLIDEAN ? bucket_bank_wgmma_kernel<INT8, EUCLIDEAN>
                                        : bucket_bank_wgmma_kernel<INT8, DOT>;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
    const dim3 grid((B + wg::BM - 1) / wg::BM, splits);
    kernel<<<grid, wg::kThreads, p.smem, stream>>>(
        qmap, vmap, (const float*)vkey, (const float*)vscale, (const float*)qscale,
        (float*)part_d, (int*)part_r, B, N_pad, n, row_bytes / wg::KB, p.stages, p.q_resident,
        splits);
    return (int)cudaGetLastError();
}

// A packed key's ordering key: the key bits with the group bits cleared, or
// BIG for a row >= n.
__device__ __forceinline__ float packed_key(int p, int gmask) {
    return p < INVALID_PACKED ? __int_as_float(p & ~gmask) : BIG;
}

// one array of the packed kernel's bank: a word per consumer thread and pair
constexpr int kConsumerThreads = wg::kConsumers * 128;
constexpr int kBankWords = wg::kAcc * kConsumerThreads;

// The packed int8 bank on the Hopper mainloop of wgmma.cuh. group = nt / 128
// sub-tiles per nt-row tile; gbits = bits of the group id. Consumer thread
// state: 32 (query, bucket) pairs of two packed int32 minima over the
// current nt-row tile, in the accumulator layout; 32 accumulators per set,
// two sets; the 16 nvkey values of the thread's columns of the next tile to
// finish. The split's bank is in shared memory after the ring's barriers,
// three arrays of [pair i][consumer thread] words (a warp reads 32
// consecutive words: no bank conflict): the best and second packed keys,
// group bits kept, and their nt-row tiles within the split as two 16-bit
// halves (best low). A slot's row is (t_begin + tile * group + group bits)
// * 128 + its column; a key >= INVALID_PACKED is (BIG, -1). Each thread
// reads and writes only its own slots.
__global__ void __launch_bounds__(wg::kThreads, 1)
packed_bank_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                         __grid_constant__ const CUtensorMap vmap, const float* __restrict__ nvkey,
                         float* __restrict__ part_d, int* __restrict__ part_r, int B, int N_pad,
                         int n, int nk, int stages, int q_resident, int group, int gbits,
                         int splits) {
    extern __shared__ uint8_t smem_raw[];
    const wg::Ring ring = wg::setup(smem_raw, nk, stages, q_resident);
    const int q0 = blockIdx.x * wg::BM, split = blockIdx.y;
    const int units = N_pad / (BN * group);
    const int t_begin = (int)((long long)split * units / splits) * group;
    const int t_end = (int)((long long)(split + 1) * units / splits) * group;
    const int gmask = (1 << gbits) - 1;

    if (threadIdx.x < 128) {
        wg::producer_regs();
        if (threadIdx.x == 0) wg::produce(ring, &qmap, &vmap, q0, t_begin, t_end, wg::KB);
    } else {
        wg::consumer_regs();
        const wg::Frag f = wg::frag();
        // volatile keeps ptxas from hoisting a fold's 96 loads ahead of their
        // use, which spilled in the epilogue (PERF.md)
        volatile int* const bank1 = reinterpret_cast<volatile int*>(
            smem_raw + (ring.qbar + 8 - wg::smem_u32(smem_raw))) + (threadIdx.x - 128);
        volatile int* const bank2 = bank1 + kBankWords;
        volatile uint32_t* const bank_t =
            reinterpret_cast<volatile uint32_t*>(bank2 + kBankWords);
        int p1[wg::kAcc], p2[wg::kAcc];
#pragma unroll
        for (int i = 0; i < wg::kAcc; ++i) {
            p1[i] = INVALID_PACKED;
            p2[i] = INVALID_PACKED;
            bank1[i * kConsumerThreads] = INVALID_PACKED;
            bank2[i * kConsumerThreads] = INVALID_PACKED;
            bank_t[i * kConsumerThreads] = 0;
        }
        float2 vk[wg::WN / 8];
        uint32_t u = 0;   // the nt-row tile within the split

        // an nt-row tile is complete: fold its best two (b, tile u) into the
        // split's bank (a) with _merge_pair2, and start the next
        auto fold = [&]() {
#pragma unroll
            for (int i = 0; i < wg::kAcc; ++i) {
                const int a1 = bank1[i * kConsumerThreads], a2 = bank2[i * kConsumerThreads];
                const uint32_t at = bank_t[i * kConsumerThreads];
                const float ka1 = packed_key(a1, gmask), ka2 = packed_key(a2, gmask);
                const float kb1 = packed_key(p1[i], gmask), kb2 = packed_key(p2[i], gmask);
                const bool a_first = ka1 <= kb1;
                const int mid = a_first ? p1[i] : a1;
                const float kmid = a_first ? kb1 : ka1;
                const uint32_t tmid = a_first ? u : at & 0xFFFFu;
                const bool a2_first = ka2 <= kb2;
                const int o2 = a2_first ? a2 : p2[i];
                const uint32_t to2 = a2_first ? at >> 16 : u;
                const bool mid_first = kmid <= (a2_first ? ka2 : kb2);
                bank1[i * kConsumerThreads] = a_first ? a1 : p1[i];
                bank2[i * kConsumerThreads] = mid_first ? mid : o2;
                bank_t[i * kConsumerThreads] = (a_first ? at & 0xFFFFu : u) | (mid_first ? tmid : to2) << 16;
                p1[i] = INVALID_PACKED;
                p2[i] = INVALID_PACKED;
            }
            ++u;
        };

        wg::consume<int>(ring, t_begin, t_end,
                         [&](int tile) {
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j)
                vk[j] = __ldg(reinterpret_cast<const float2*>(nvkey + tile * BN + f.col0 + 8 * j));
        },
                         [&](auto& acc, int tile) {
            const int gi = tile % group;
            const int lim = n - tile * BN - f.col0;   // column offsets below lim are live
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = 4 * j + 2 * h + e;
                        // an s32 dot converts exactly below 2^24 (D <= 1040)
                        const float dot = static_cast<float>(acc[i]);
                        const float key = __fadd_rn(__fmul_rn(dot, pick(vk[j], e)), PACK_BIAS);
                        const int p = 8 * j + e < lim ? (__float_as_int(key) & ~gmask) | gi
                                                      : INVALID_PACKED;
                        // keys are unique within an nt-row tile: no tie rule
                        p2[i] = min(p2[i], max(p1[i], p));
                        p1[i] = min(p1[i], p);
                    }
            if (gi == group - 1) fold();
        });

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = q0 + f.row0 + 8 * h;
            if (q >= B) continue;
            const long long base = ((long long)split * B + q) * (2 * BN);
#pragma unroll
            for (int j = 0; j < wg::WN / 8; ++j) {
                const int c = f.col0 + 8 * j, i = 4 * j + 2 * h;
                float d1[2], d2[2];
                int r1[2], r2[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int s = (i + e) * kConsumerThreads;
                    const int k1 = bank1[s], k2 = bank2[s];
                    const uint32_t at = bank_t[s];
                    d1[e] = packed_key(k1, gmask);
                    d2[e] = packed_key(k2, gmask);
                    r1[e] = k1 < INVALID_PACKED
                        ? (t_begin + (int)(at & 0xFFFFu) * group + (k1 & gmask)) * BN + c + e
                        : -1;
                    r2[e] = k2 < INVALID_PACKED
                        ? (t_begin + (int)(at >> 16) * group + (k2 & gmask)) * BN + c + e
                        : -1;
                }
                *reinterpret_cast<float2*>(part_d + base + c) = make_float2(d1[0], d1[1]);
                *reinterpret_cast<float2*>(part_d + base + BN + c) = make_float2(d2[0], d2[1]);
                *reinterpret_cast<int2*>(part_r + base + c) = make_int2(r1[0], r1[1]);
                *reinterpret_cast<int2*>(part_r + base + BN + c) = make_int2(r2[0], r2[1]);
            }
        }
    }
}

int launch_packed(const void* v8, const void* nvkey, const void* q8, void* part_d, void* part_r,
                  int B, int N_pad, int D, int n, int group, int gbits, int splits,
                  cudaStream_t stream) {
    // a slot keeps its nt-row tile within the split in 16 bits
    const int units = N_pad / (BN * group);
    if ((units + splits - 1) / splits > 0x10000) return (int)cudaErrorInvalidValue;
    const wg::Plan p = wg::plan(D, 3 * kBankWords * 4);
    CUtensorMap qmap, vmap;
    int err = wg::encode_rows(&qmap, q8, D, B, wg::BM, true);
    if (err == 0) err = wg::encode_rows(&vmap, v8, D, N_pad, wg::BN, true);
    if (err != 0) return err;
    err = (int)cudaFuncSetAttribute(packed_bank_wgmma_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
    const dim3 grid((B + wg::BM - 1) / wg::BM, splits);
    packed_bank_wgmma_kernel<<<grid, wg::kThreads, p.smem, stream>>>(
        qmap, vmap, (const float*)nvkey, (float*)part_d, (int*)part_r, B, N_pad, n, D / wg::KB,
        p.stages, p.q_resident, group, gbits, splits);
    return (int)cudaGetLastError();
}

__global__ void bucket_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_r,
                                    float* __restrict__ out_d, int* __restrict__ out_r, int B,
                                    int splits) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)B * BN) return;
    const long long q = idx / BN;
    const int c = (int)(idx % BN);
    const long long o = q * (2 * BN) + c;
    float a1 = part_d[o], a2 = part_d[o + BN];
    int ai1 = part_r[o], ai2 = part_r[o + BN];
    for (int s = 1; s < splits; ++s) {
        const long long p = (long long)s * B * (2 * BN) + o;
        merge2(a1, ai1, a2, ai2, part_d[p], part_r[p], part_d[p + BN], part_r[p + BN]);
    }
    out_d[o] = a1;
    out_d[o + BN] = a2;
    out_r[o] = ai1;
    out_r[o + BN] = ai2;
}

}  // namespace

extern "C" int bucket_bank_bf16(const void* vectors, const void* vkey, const void* queries,
                                void* part_d, void* part_r, int B, int N_pad, int D, int n,
                                int metric, int splits, void* stream) {
    if (B > 0 && splits > 0)
        return launch_bank<false>(vectors, vkey, nullptr, queries, nullptr, part_d, part_r, B,
                                  N_pad, D, n, metric, splits, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int bucket_bank_int8(const void* v8, const void* vkey, const void* vscale,
                                const void* q8, const void* qscale, void* part_d, void* part_r,
                                int B, int N_pad, int D, int n, int metric, int splits,
                                void* stream) {
    if (B > 0 && splits > 0)
        return launch_bank<true>(v8, vkey, vscale, q8, qscale, part_d, part_r, B, N_pad, D, n,
                                 metric, splits, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int packed_bank_int8(const void* v8, const void* nvkey, const void* q8, void* part_d,
                                void* part_r, int B, int N_pad, int D, int n, int group,
                                int gbits, int splits, void* stream) {
    if (B > 0 && splits > 0)
        return launch_packed(v8, nvkey, q8, part_d, part_r, B, N_pad, D, n, group, gbits, splits,
                             (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

extern "C" int bucket_merge(const void* part_d, const void* part_r, void* out_d, void* out_r,
                            int B, int splits, void* stream) {
    if (B > 0) {
        const long long total = (long long)B * BN;
        const int threads = 256;
        bucket_merge_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>((const float*)part_d, (const int*)part_r,
                                                      (float*)out_d, (int*)out_r, B, splits);
    }
    return (int)cudaGetLastError();
}

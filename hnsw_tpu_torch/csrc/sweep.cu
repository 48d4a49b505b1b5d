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
// (int8); |v|^2 is given. Rows >= n take the distance BIG, as in the plain
// version. The result per query is the k smallest (distance, row) pairs in
// lexicographic order, ascending, with (BIG, -1) for missing rows. That is
// what the reference's k min-sweeps per tile and sorted merges compute (ties
// go to the lower row), so the order in which rows are visited, and how they
// are cut into parts whose lists are merged, does not change the answer.
//
// Bound on the H100: tensor-core operations, 2*B*N*D of them, plus the
// per-element distance and selection. Design: sweep_wgmma_kernel<INT8,
// METRIC> runs the TMA ring and wgmma of wgmma.cuh (the query block resident
// or streamed) with its own consumer loop, consume_pingpong: each of the two
// consumer warpgroups takes whole 128-row tiles in turn (two m64n64 wgmma per
// k step) and selects from a finished tile's accumulator registers while the
// other consumer's products run. A named barrier orders the two. In the
// wgmma layout a consumer thread owns two query rows and 32 columns of every
// tile it takes, so each consumer keeps its own running lists (two partial
// lists a query per split) and sweep_merge folds the 2 * S lists of a query.
// Per consumer warp, registers hold:
// - the sorted lists of the warp's 16 query rows, one slot a lane (lane i
//   holds slot i of every list): 16 distances and 16 rows;
// - the gate of the thread's two rows: the better (distance, row) of the
//   k-th entries of its consumer's list and of the other consumer's, which
//   each publishes in shared memory (1 KB); an element after either k-th
//   entry has k better rows and cannot be in the answer;
// - the two accumulator sets of the tile (64), and the |v|^2 (and int8
//   vscale) of its 32 columns, loaded before its products.
// Per element: the dequantize (int8) and, for cosine and euclidean, a cheap
// test that cannot reject an element the exact test would keep (below),
// setting a bit of the row's 32-bit mask; for dot the exact test itself.
// Rows >= n are a mask, not a branch. Then rounds: while a lane of the warp
// has a marked element, each lane forms the exact distance() of its next
// one, and the candidates that beat their row's gate (before()) are inserted
// one at a time (ballot, then a shift of the lanes above the insert point).
// No list, accumulator or distance is indexed with a run-time value: trees
// of selects pick them. A consumer's first tile builds its lists in bulk
// instead of by some 128 inserts a list: every distance of the tile, then
// each list's 128 candidates as four warp-wide lists, each sorted by a
// bitonic network and merged into the running one.
//
// The cheap test. cosine: r' = dot * rsqrt.approx(max(|q|^2 |v|^2, 1e-12))
// is within 2^-21 |r'| of the exact ratio dot / sqrt(...) (rsqrt.approx
// 2^-22.9, one rounding, against the exact path's two); an element is tested
// exactly when r' + 2^-19 |r'| >= (1 - t) - 2^-20 (|t| + 1), t the gate,
// which every ratio whose distance 1 - r rounds to <= t satisfies.
// euclidean: the argument of the sqrt is formed with the reference's
// operations; an element is tested exactly when it is <= t^2 (1 + 1e-6) +
// 1e-30, since sqrt_rn is monotone and within half an ulp.
// tests/test_torch_sweep_plan.py holds both margins in numpy float32.
//
// The distance epilogue is written with __fmul_rn/__fadd_rn/__fsub_rn/
// __fdiv_rn/__fsqrt_rn so that nvcc contracts nothing into an FMA that the
// plain version does not form.

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float BIG = 1e30f;
enum { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };
constexpr int kMaxK = 32;                    // one list slot per lane
constexpr int kMaxLists = 32;                // partial lists a query, all splits
constexpr int kRows = 16;                    // query rows of a consumer warp
constexpr int kConsumerLists = wg::kConsumers * wg::BM;   // published thresholds
constexpr int NO_ROW = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
// the cheap test before the exact distance (cosine and euclidean)
constexpr bool kFilter = true;
constexpr float kRatioSlack = 1.9073486e-6f;     // 2^-19
constexpr float kCutSlack = 9.5367432e-7f;       // 2^-20

// One (distance, row) pair in shared memory, as one 64-bit access: the
// other consumer reads it while this one writes it.
__device__ __forceinline__ void store_pair(uint32_t addr, float d, int r) {
    asm volatile("st.volatile.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "f"(d), "r"(r)
                 : "memory");
}

__device__ __forceinline__ void load_pair(uint32_t addr, float& d, int& r) {
    asm volatile("ld.volatile.shared.v2.b32 {%0, %1}, [%2];\n"
                 : "=f"(d), "=r"(r)
                 : "r"(addr)
                 : "memory");
}

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

// element e of a column pair
__device__ __forceinline__ float pick(float2 v, int e) { return e ? v.y : v.x; }

// v[i] for a run-time i < N (a power of two), by a tree of selects: never an
// index, which would send the array to local memory
template <int N, typename T>
__device__ __forceinline__ T pick_n(const T (&v)[N], int i) {
    T t[N];
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = v[j];
#pragma unroll
    for (int s = 1; s < N; s <<= 1)
#pragma unroll
        for (int j = 0; j < N; j += 2 * s) t[j] = (i & s) ? t[j + s] : t[j];
    return t[0];
}

// 1 / sqrt(x) to 2^-22.9 (PTX rsqrt.approx), for x >= 1e-12: no denormal
// to guard against
__device__ __forceinline__ float rsqrt_approx(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Element b < 32 of a thread's row in a tile is column offset
// 64 (b / 16) + 8 (b % 16 / 2) + b % 2 from the thread's col0; the offsets
// rise with b, so the elements below lim are a prefix.
__device__ __forceinline__ int column_of(int b) {
    return 64 * (b >> 4) + 8 * ((b & 15) >> 1) + (b & 1);
}

__device__ __forceinline__ unsigned live_bits(int lim) {
    auto half = [](int l) { return l <= 0 ? 0 : l >= 58 ? 16 : 2 * (l >> 3) + min(l & 7, 2); };
    const int c = half(lim) + half(lim - 64);
    return c == 32 ? 0xFFFFFFFFu : (1u << c) - 1u;
}

// A compare-exchange step of a bitonic network across the warp: the lane
// pair (lane, lane ^ stride) orders its two (distance, row) pairs ascending
// when `ascending`, else descending.
__device__ __forceinline__ void exchange(float& d, int& r, int stride, bool ascending) {
    const int lane = threadIdx.x & 31;
    const float od = __shfl_xor_sync(FULL, d, stride);
    const int orow = __shfl_xor_sync(FULL, r, stride);
    const bool take = ((lane & stride) == 0) == ascending ? before(od, orow, d, r)
                                                         : before(d, r, od, orow);
    d = take ? od : d;
    r = take ? orow : r;
}

// Sort one (distance, row) pair a lane ascending across the warp.
__device__ __forceinline__ void sort32(float& d, int& r) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1)
            exchange(d, r, stride, (lane & size) == 0);
}

// (d, r) := the 32 smallest of two ascending warp-wide lists, ascending:
// the lane-wise smaller of a and reversed b is bitonic, then sorted.
__device__ __forceinline__ void merge32(float& d, int& r, float bd, int br) {
    const int lane = threadIdx.x & 31;
    const float md = __shfl_sync(FULL, bd, 31 - lane);
    const int mr = __shfl_sync(FULL, br, 31 - lane);
    if (before(md, mr, d, r)) {
        d = md;
        r = mr;
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) exchange(d, r, stride, true);
}

// Named barriers 1 and 2 between the two consumer warpgroups (256 threads):
// one arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The consumer loop of the sweeps, ping-pong: consumer warpgroup w takes the
// whole tiles t_begin + w, t_begin + w + 2, ... of its split (two m64n64
// wgmma per k step, columns 0-63 into lo and 64-127 into hi), and runs each
// tile's epilogue on its accumulators once that tile's groups are retired,
// while the other consumer's products keep the tensor cores busy. Chunk g of
// the split sits in stage g % stages, phase (g / stages) & 1, and its one
// consumer frees it (4 warp arrivals). A consumer starts tile t only once the
// other has freed all of tile t - 1 (named barrier 1 + w, arrived on after
// that tile's last chunk): then every earlier use of a stage is freed, so the
// parity wait on `full` cannot pass a phase early, and the products of the
// two consumers alternate. load(t) runs before tile t's chunks.
template <typename Acc, typename Load, typename Epilogue>
__device__ __forceinline__ void consume_pingpong(const wg::Ring& r, int t_begin, int t_end,
                                                 Load&& load, Epilogue&& epilogue) {
    const int w = threadIdx.x / 128 - 1;
    if (t_begin + w >= t_end) return;
    if (r.q_resident) wg::mbar_wait(r.qbar, 0);
    Acc lo[wg::kAcc], hi[wg::kAcc];
    for (int t = t_begin + w; t < t_end; t += 2) {
        load(t);
        // the other consumer has freed every chunk before this tile's
        if (t > t_begin) named_sync(1 + w);
        const int g0 = (t - t_begin) * r.nk;
        int prev = 0;
        for (int kc = 0; kc < r.nk; ++kc) {
            const int g = g0 + kc, stage = g % r.stages;
            wg::mbar_wait(r.full + 8 * stage, (g / r.stages) & 1);
            const uint64_t da = wg::desc_sw128(r.base + (r.q_resident ? kc : stage) * wg::kQChunk);
            const uint64_t db = wg::desc_sw128(r.v_base + stage * wg::kVChunk);
            wg::fence_acc(lo);
            wg::fence_acc(hi);
            wg::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < wg::KB / 32; ++ks) {
                wg::mma(lo, da + 2 * ks, db + 2 * ks, kc != 0 || ks != 0);
                wg::mma(hi, da + 2 * ks, db + (wg::WN * wg::KB >> 4) + 2 * ks, kc != 0 || ks != 0);
            }
            wg::wgmma_commit();
            if (kc != 0) {
                // the chunk before this one is retired: free its stage
                wg::wgmma_wait<1>();
                __syncwarp();
                if ((threadIdx.x & 31) == 0) wg::mbar_arrive(r.empty + 8 * prev);
            }
            prev = stage;
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(lo);
        wg::fence_acc(hi);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) wg::mbar_arrive(r.empty + 8 * prev);
        if (t + 1 < t_end) named_arrive(2 - w);
        epilogue(lo, hi, t);
    }
}

template <bool INT8, int METRIC>
__global__ void __launch_bounds__(wg::kThreads, 1)
sweep_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                   __grid_constant__ const CUtensorMap vmap, const float* __restrict__ v_sq,
                   const float* __restrict__ vscale, const uint16_t* __restrict__ queries,
                   const float* __restrict__ qmeta, float* __restrict__ part_d,
                   int* __restrict__ part_r, int B, int N_pad, int D, int n, int k, int nk,
                   int stages, int q_resident, int splits) {
    using Acc = typename std::conditional<INT8, int, float>::type;
    extern __shared__ uint8_t smem_raw[];
    // each chunk has one consumer: a stage is free after its 4 warps arrive
    const wg::Ring ring = wg::setup(smem_raw, nk, stages, q_resident, 4);
    // the published thresholds: thr[w][r] = (k-th distance, row) of consumer
    // w's list of block row r, after the barriers
    const uint32_t thr = ring.qbar + 8;
    if (threadIdx.x < kConsumerLists) store_pair(thr + 8 * threadIdx.x, BIG, NO_ROW);
    __syncthreads();
    const int q0 = blockIdx.x * wg::BM, split = blockIdx.y;
    const int ntiles_all = N_pad / wg::BN;
    const int t_begin = (int)((long long)split * ntiles_all / splits);
    const int t_end = (int)((long long)(split + 1) * ntiles_all / splits);

    if (threadIdx.x < 128) {
        wg::producer_regs();
        if (threadIdx.x == 0)
            wg::produce(ring, &qmap, &vmap, q0, t_begin, t_end, INT8 ? wg::KB : wg::KB / 2);
        return;
    }
    wg::consumer_regs();
    const int lane = threadIdx.x & 31, quad = lane >> 2;
    const int w = threadIdx.x / 128 - 1, v = (threadIdx.x & 127) >> 5;
    const int row0 = 16 * v + quad;          // the thread's block rows: row0, row0 + 8
    const int col0 = 2 * (lane & 3);         // its columns: col0 + column_of(b), b < 32
    const uint32_t thr_own = thr + 8 * wg::BM * w, thr_other = thr + 8 * wg::BM * (1 - w);

    // the thread's two query rows: |q|^2 and (int8) the dequantization scale
    float qsq[2], qs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + row0 + 8 * h;
        if constexpr (INT8) {
            qs[h] = q < B ? qmeta[2 * q] : 0.f;
            qsq[h] = q < B ? qmeta[2 * q + 1] : 0.f;
        } else {
            // the bf16 query widened exactly, summed in f32 by the quad
            float s = 0.f;
            if (q < B) {
                const uint4* row = reinterpret_cast<const uint4*>(queries + (long long)q * D);
                for (int c = lane & 3; c < D / 8; c += 4) {
                    const uint4 u = __ldg(row + c);
                    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        const float lo = __uint_as_float(words[m] << 16);
                        const float hi = __uint_as_float(words[m] & 0xffff0000u);
                        s = __fadd_rn(s, __fmul_rn(lo, lo));
                        s = __fadd_rn(s, __fmul_rn(hi, hi));
                    }
                }
            }
            s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 1));
            s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 2));
            qsq[h] = s;
            qs[h] = 0.f;
        }
    }

    // list t of the warp is block row 16v + t, held by quad t % 8 as its row
    // h = t / 8; lane i holds its slot i
    float ld[kRows];
    int lr[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) { ld[t] = BIG; lr[t] = NO_ROW; }
    // the gate of the thread's rows: the better of the k-th entries of this
    // consumer's and the other consumer's lists of the row
    float wd[2] = {BIG, BIG};
    int wr[2] = {NO_ROW, NO_ROW};
    float2 vq[16];                           // |v|^2 of columns col0 + column_of(2i), + 1
    float2 vs[INT8 ? 16 : 1];                // (int8) their vscale

    consume_pingpong<Acc>(ring, t_begin, t_end,
                          [&](int tile) {
        const int c = tile * wg::BN + col0;
#pragma unroll
        for (int i = 0; i < 16; ++i)
            vq[i] = __ldg(reinterpret_cast<const float2*>(v_sq + c + column_of(2 * i)));
        if constexpr (INT8) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
                vs[i] = __ldg(reinterpret_cast<const float2*>(vscale + c + column_of(2 * i)));
        }
    },
                          [&](const Acc (&lo)[wg::kAcc], const Acc (&hi)[wg::kAcc], int tile) {
        const int row_base = tile * wg::BN + col0;
        const int lim = n - row_base;            // column offsets below lim are live
        const unsigned live = live_bits(lim);
        // element b of row h: accumulator 4j + 2h + e of lo (b < 16) or hi,
        // j = b % 16 / 2, e = b % 2
        auto dot_of = [&](auto h_, int b) {
            constexpr int H = decltype(h_)::value;
            float x[32];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                x[i] = static_cast<float>(lo[4 * (i >> 1) + 2 * H + (i & 1)]);
                x[16 + i] = static_cast<float>(hi[4 * (i >> 1) + 2 * H + (i & 1)]);
            }
            float dot = pick_n(x, b);                     // exact below 2^24 (s32)
            if constexpr (INT8)
                dot = __fmul_rn(__fmul_rn(dot, qs[H]), pick(pick_n(vs, b >> 1), b & 1));
            return dot;
        };
        // The consumer's first tile: its lists are empty, so instead of up to
        // 128 inserts a list, every distance of the tile is formed (both
        // rows, after which the accumulators are dead), and each list is
        // built from its 128 candidates (quad g's 4 lanes x 32 elements) in
        // bulk: gathered as four warp-wide lists (element b + 8m of source
        // lane 4g + lane % 4 at lane 4b + lane % 4, m < 4), each sorted by a
        // bitonic network and merged into the running one.
        auto seed = [&]() {
            float dd[2][32];
#pragma unroll
            for (int b = 0; b < 32; ++b) {
                const bool live_b = column_of(b) < lim;
                const float vsq = pick(vq[b >> 1], b & 1);
                dd[0][b] = live_b ? distance(dot_of(std::integral_constant<int, 0>{}, b),
                                             qsq[0], vsq, METRIC)
                                  : BIG;
                dd[1][b] = live_b ? distance(dot_of(std::integral_constant<int, 1>{}, b),
                                             qsq[1], vsq, METRIC)
                                  : BIG;
            }
            const int b0 = lane >> 2;
#pragma unroll
            for (int H = 0; H < 2; ++H) {
#pragma unroll 1
                for (int g = 0; g < 8; ++g) {
                    const int src = 4 * g + (lane & 3);
                    float ad = BIG;
                    int ar = NO_ROW;
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        float cd = BIG;
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            const float x = __shfl_sync(FULL, dd[H][u + 8 * m], src);
                            cd = b0 == u ? x : cd;
                        }
                        int cr = row_base + column_of(b0 + 8 * m);
                        sort32(cd, cr);
                        if (m == 0) {
                            ad = cd;
                            ar = cr;
                        } else {
                            merge32(ad, ar, cd, cr);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        ld[8 * H + u] = u == g ? ad : ld[8 * H + u];
                        lr[8 * H + u] = u == g ? ar : lr[8 * H + u];
                    }
                    const float kd = __shfl_sync(FULL, ad, k - 1);
                    const int kr = __shfl_sync(FULL, ar, k - 1);
                    if (lane == 0) store_pair(thr_own + 8 * (16 * v + 8 * H + g), kd, kr);
                    const bool tighter = quad == g && before(kd, kr, wd[H], wr[H]);
                    wd[H] = tighter ? kd : wd[H];
                    wr[H] = tighter ? kr : wr[H];
                }
            }
        };
        auto row_pass = [&](auto h_) {
            constexpr int H = decltype(h_)::value;
            // the other consumer's list of this row may have a better k-th
            float od;
            int orow;
            load_pair(thr_other + 8 * (row0 + 8 * H), od, orow);
            if (before(od, orow, wd[H], wr[H])) { wd[H] = od; wr[H] = orow; }
            // the cheap pass: which elements may beat the gate
            [[maybe_unused]] float cut = 0.f;
            if constexpr (METRIC == COSINE)
                cut = (1.f - wd[H]) - kCutSlack * (fabsf(wd[H]) + 1.f);
            else if constexpr (METRIC == EUCLIDEAN)
                cut = wd[H] * wd[H] * 1.000001f + 1e-30f;
            unsigned mb = 0u;
#pragma unroll
            for (int b = 0; b < 32; ++b) {
                const int a = 4 * ((b & 15) >> 1) + 2 * H + (b & 1);
                float dot = static_cast<float>(b < 16 ? lo[a] : hi[a]);
                if constexpr (INT8) dot = __fmul_rn(__fmul_rn(dot, qs[H]), pick(vs[b >> 1], b & 1));
                const float vsq = pick(vq[b >> 1], b & 1);
                bool m = true;
                if constexpr (METRIC == DOT) {
                    m = before(-dot, row_base + column_of(b), wd[H], wr[H]);
                } else if constexpr (kFilter && METRIC == COSINE) {
                    const float r =
                        __fmul_rn(dot, rsqrt_approx(fmaxf(__fmul_rn(qsq[H], vsq), 1e-12f)));
                    m = fmaf(fabsf(r), kRatioSlack, r) >= cut;
                } else if constexpr (kFilter && METRIC == EUCLIDEAN) {
                    m = __fsub_rn(__fadd_rn(qsq[H], vsq), __fmul_rn(2.f, dot)) <= cut;
                }
                mb |= (unsigned)m << b;
            }
            // rows >= n have the distance BIG
            mb = (mb & live) | (wd[H] >= BIG ? ~live : 0u);
            // each round: every lane takes the exact distance of its next
            // marked element; the candidates that beat their row's gate are
            // inserted one at a time into the list of their quad
            while (__any_sync(FULL, mb != 0u)) {
                const int b = mb ? __ffs(mb) - 1 : 0;
                const bool had = mb != 0u;
                mb &= mb - 1u;
                const int col = column_of(b), row = row_base + col;
                const float d = col < lim ? distance(dot_of(h_, b), qsq[H],
                                                     pick(pick_n(vq, b >> 1), b & 1), METRIC)
                                          : BIG;
                const unsigned cand = __ballot_sync(FULL, had && before(d, row, wd[H], wr[H]));
                for (unsigned m = cand; m != 0u; m &= m - 1u) {
                    const int src = __ffs(m) - 1, g = src >> 2;
                    const float cd = __shfl_sync(FULL, d, src);
                    const int cr = __shfl_sync(FULL, row, src);
                    // the gate may have tightened since the round began
                    if (!__shfl_sync(FULL, (int)before(d, row, wd[H], wr[H]), src)) continue;
                    float ldg = ld[8 * H];               // list 8H + g
                    int lrg = lr[8 * H];
#pragma unroll
                    for (int u = 1; u < 8; ++u) {
                        ldg = u == g ? ld[8 * H + u] : ldg;
                        lrg = u == g ? lr[8 * H + u] : lrg;
                    }
                    const int pos =
                        __popc(__ballot_sync(FULL, lane < k && before(ldg, lrg, cd, cr)));
                    const float up_d = __shfl_up_sync(FULL, ldg, 1);
                    const int up_r = __shfl_up_sync(FULL, lrg, 1);
                    ldg = lane == pos ? cd : lane > pos ? up_d : ldg;
                    lrg = lane == pos ? cr : lane > pos ? up_r : lrg;
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        ld[8 * H + u] = u == g ? ldg : ld[8 * H + u];
                        lr[8 * H + u] = u == g ? lrg : lr[8 * H + u];
                    }
                    const float kd = __shfl_sync(FULL, ldg, k - 1);
                    const int kr = __shfl_sync(FULL, lrg, k - 1);
                    if (lane == src) store_pair(thr_own + 8 * (16 * v + 8 * H + g), kd, kr);
                    const bool tighter = quad == g && before(kd, kr, wd[H], wr[H]);
                    wd[H] = tighter ? kd : wd[H];
                    wr[H] = tighter ? kr : wr[H];
                }
            }
        };
        if (tile == t_begin + w) {
            seed();
        } else {
            row_pass(std::integral_constant<int, 0>{});
            row_pass(std::integral_constant<int, 1>{});
        }
        __syncwarp();
    });

    // consumer w's list of query q, split s: partial list 2s + w
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
        const int q = q0 + 16 * v + t;
        if (q >= B || lane >= k) continue;
        const long long o = ((long long)(2 * split + w) * B + q) * k + lane;
        part_d[o] = ld[t];
        part_r[o] = ld[t] < BIG ? lr[t] : -1;
    }
}

// Merge the L sorted partial lists [L, B, k] of each query into [B, k].
__global__ void sweep_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_r,
                                   float* __restrict__ out_d, int* __restrict__ out_r, int B, int k,
                                   int lists) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= B) return;
    int head[kMaxLists];
    for (int s = 0; s < lists; ++s) head[s] = 0;
    for (int j = 0; j < k; ++j) {
        int best = 0;
        float bd = BIG;
        int br = NO_ROW;
        bool found = false;
        for (int s = 0; s < lists; ++s) {
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

// A sweep: tensor maps, shared memory, launch. part_d / part_r hold
// [2 * splits, B, k].
template <bool INT8>
int launch_sweep(const void* vectors, const void* v_sq, const void* vscale, const void* queries,
                 const void* qmeta, void* part_d, void* part_r, int B, int N_pad, int D, int n,
                 int k, int metric, int splits, cudaStream_t stream) {
    if (k < 1 || k > kMaxK || splits < 1 || 2 * splits > kMaxLists)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const int row_bytes = INT8 ? D : 2 * D;
    const wg::Plan p = wg::plan(row_bytes, 8 * kConsumerLists);
    CUtensorMap qmap, vmap;
    int err = wg::encode_rows(&qmap, queries, row_bytes, B, wg::BM, INT8);
    if (err == 0) err = wg::encode_rows(&vmap, vectors, row_bytes, N_pad, wg::BN, INT8);
    if (err != 0) return err;
    auto kernel = metric == COSINE      ? sweep_wgmma_kernel<INT8, COSINE>
                  : metric == EUCLIDEAN ? sweep_wgmma_kernel<INT8, EUCLIDEAN>
                                        : sweep_wgmma_kernel<INT8, DOT>;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
    const dim3 grid((B + wg::BM - 1) / wg::BM, splits);
    kernel<<<grid, wg::kThreads, p.smem, stream>>>(
        qmap, vmap, (const float*)v_sq, (const float*)vscale, (const uint16_t*)queries,
        (const float*)qmeta, (float*)part_d, (int*)part_r, B, N_pad, D, n, k, row_bytes / wg::KB,
        p.stages, p.q_resident, splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sweep_topk_bf16(const void* vectors, const void* v_sq, const void* queries,
                               void* part_d, void* part_r, int B, int N_pad, int D, int n, int k,
                               int metric, int splits, void* stream) {
    return launch_sweep<false>(vectors, v_sq, nullptr, queries, nullptr, part_d, part_r, B, N_pad,
                               D, n, k, metric, splits, (cudaStream_t)stream);
}

extern "C" int sweep_topk_int8(const void* v8, const void* v_sq, const void* vscale,
                               const void* q8, const void* qmeta, void* part_d, void* part_r,
                               int B, int N_pad, int D, int n, int k, int metric, int splits,
                               void* stream) {
    return launch_sweep<true>(v8, v_sq, vscale, q8, qmeta, part_d, part_r, B, N_pad, D, n, k,
                              metric, splits, (cudaStream_t)stream);
}

extern "C" int sweep_merge(const void* part_d, const void* part_r, void* out_d, void* out_r,
                           int B, int k, int lists, void* stream) {
    if (k < 1 || k > kMaxK || lists < 1 || lists > kMaxLists) return (int)cudaErrorInvalidValue;
    if (B > 0) {
        const int threads = 128;
        sweep_merge_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            (const float*)part_d, (const int*)part_r, (float*)out_d, (int*)out_r, B, k, lists);
    }
    return (int)cudaGetLastError();
}

// The HNSW search's candidate scoring where it reads rows, not a neighbour
// pack: each valid candidate's row gathered and dotted with the query in
// place, one block a query, or at rows of at most 512 bytes one warp for
// 32 slots.
//
// Hand-written, with no pallas_call counterpart: it replaces the f32 gather
// and einsum of the reference's hop body (hnsw_tpu/models/hnsw/search.py,
// _score: vectors[rows], the "bd,bcd->bc" einsum, the norms and the mask),
// XLA ops, which the port ran as PyTorch's gather, a cuBLAS gemv and a
// where. At B = 1,024, C = 128, D = 896 (an f32 loop) that writes a
// [B, C, D] f32 tensor of 470 MB, reads it back and then masks the slots
// that were never valid: about 1.3 GB a body. The same function scores the
// multi-entry seeds, the first entry's distance and the exact re-rank.
//
// Contract (ops/distance.py:shadow_score). For query b and slot s < C,
// with r = rows[b, s] clamped into [0, N_pad):
//   out[b, s] = BIG                                            if !valid[b, s]
//             = dist(dot(round(q[b]), vectors[r]), q_sq[b], v_sq[r])   else.
// round() is to the rows' type (bf16: to nearest even; f32: none); the
// products and their sums are f32 fused multiply-adds, so only the order of
// the sums differs from the plain version; dist() is ops/distance.py's
// _dist_bc for the metric, operation by operation, with no fused
// multiply-add. A row that is not valid is never read.
//
// Bound on the H100: bytes, read at random. Each valid slot's row is read
// once: at a valid share of 0.688, 90,200 rows of 3,584 bytes a body at the
// shape above, 323 MB, 0.096 ms at 3.35 TB/s; the ids, flags, norms and the
// output add about 1.3 MB. So the design reads nothing else, writes only
// the [B, C] output, and keeps enough rows in flight. Two plans, picked per
// launch from the row's 16-byte chunks alone: a block a query for wide rows
// (gather_score_kernel), a warp for 32 slots where a row is at most 32
// chunks (gather_score_kernel_warp, below).
//
// The block plan (rows of more than 32 chunks):
// - A block of kThreads threads takes one query. The query, rounded to the
//   rows' type, is staged once in shared memory in the rows' 16-byte
//   layout.
// - The valid slots are compacted by a ballot prefix, kThreads slots a
//   round: each valid slot's place in a shared list holds its slot, its
//   row and its norm, loaded there by the slot's own thread; a slot that is
//   not valid gets BIG at once.
// - Lanes are mapped to (row, 16-byte chunk): `lanes` lanes share a row
//   (its chunks rounded up to a power of two, at most 32), 32 / lanes rows
//   a warp-step; lane `sub` of a row takes its chunks sub, sub + lanes, ...,
//   so one load instruction of a warp reads 512 contiguous bytes of a row.
//   A warp takes G warp-steps of the list at once and issues all their
//   loads before it uses any: G x NC loads of 16 bytes a lane in flight
//   (two rows of seven chunks a lane at D = 896 f32: 7 KB a warp, over
//   100 KB an SM at two blocks an SM, where the card needs about 20 KB an
//   SM to keep its memory busy). Eight warps a block keep a query's chain
//   of dependent loads short (about six round trips at 88 valid rows), so
//   the last blocks of a launch leave little tail.
// - Each row's sum is reduced over its lanes by xor shuffles; the row's
//   first lane computes its distance and writes it.
// - Any B, C and N_pad, and any D whose rows are whole 16-byte chunks: NC
//   is the chunks a lane takes of a row in one pass (2, 4 or 8: the warp
//   plan takes rows of one chunk a lane), and a wider row takes several
//   passes. The query's chunks bound D
//   (hop_gather_score_shared_bytes is 0 past a block's shared memory).
//
// The warp plan (rows of at most 32 chunks: f32 D <= 128, bf16 D <= 256).
// Under the block plan a 512-byte row (sift's D = 128 f32) left the kernel
// at 39% of its byte bound: half of a block's threads held no slot at
// C = 128, three dependent trips to memory and two block barriers came
// before the first row load, and about 86 valid rows took a second,
// mostly empty pass of the list. Here no barrier and no shared memory:
// - A warp owns 32 consecutive slots of one query (four warps a query at
//   C = 128). Each lane loads its slot's flag and id in one trip, a ballot
//   gives the warp's valid slots, and lane j takes the id of the j-th valid
//   slot by one shuffle from its owner.
// - L lanes share a row (its chunks rounded up to a power of two), 32 / L
//   rows a warp-step, lane (sub, p) taking chunk sub of row step * 32/L + p;
//   at L = 32 one load instruction of a warp reads a whole 512-byte row,
//   past L1. A warp issues the loads of kWarpSteps warp-steps before their
//   products, the slots' norms in the same wave; its query chunk sits in
//   registers.
// - The G sums a lane holds of a batch are halved over the row's lanes
//   (a lane keeps half and sends half to its partner, largest offset
//   first), leaving one partial a batch, and the batches' partials are
//   halved the same way: L - 1 shuffles in all (31 for 32 rows, where a
//   5-round sum a row took 160), after which lane j holds the sum of the
//   j-th valid row. Each lane takes its own slot's sum by one shuffle and
//   writes its distance, or BIG: one coalesced 128-byte store a warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // threads a block (a query)
constexpr int kWarps = kThreads / 32;
// blocks an SM must hold (the launch bounds): at most 128 registers a
// thread
constexpr int kMinBlocks = 2;
constexpr int kSmemMax = 232448;          // shared memory a block can have
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;             // ops/distance.py BIG

// warp-steps a warp scores at once, by chunks a lane a pass: 64 registers
// of loads in flight a lane
__host__ __device__ constexpr int batch_steps(int nc) { return 16 / nc; }

template <typename T> struct Vals { static constexpr int n = 16 / sizeof(T); };

// the dynamic shared memory of a block: the query's chunks, then the list's
// slots, rows and norms (kThreads each) and the warps' counts
__host__ inline long long shared_bytes(int chunks) {
    return (long long)chunks * 16 + (long long)kThreads * 12 + kWarps * 4;
}

// the query's values at one chunk of a row, rounded to T, in the row's
// layout: four f32, or eight bf16 in pairs (the first in the low half)
template <typename T>
__device__ __forceinline__ uint4 load_query(const float* __restrict__ qrow, int c) {
    constexpr int V = Vals<T>::n;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; j += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(qrow + (long long)c * V + j));
        v[j] = x.x;
        v[j + 1] = x.y;
        v[j + 2] = x.z;
        v[j + 3] = x.w;
    }
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 2)
            w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k])) |
                   ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])) << 16);
        else
            w[k] = __float_as_uint(v[k]);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc + the products of one 16-byte chunk of the query and of a row, value
// by value in order, as f32 fused multiply-adds (a bf16 value is its f32
// value's high half)
template <typename T>
__device__ __forceinline__ float dot_chunk(uint4 q, uint4 raw, float acc) {
    const uint32_t a[4] = {q.x, q.y, q.z, q.w}, r[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 2) {
            acc = fmaf(__uint_as_float(a[k] << 16), __uint_as_float(r[k] << 16), acc);
            acc = fmaf(__uint_as_float(a[k] & 0xffff0000u), __uint_as_float(r[k] & 0xffff0000u),
                       acc);
        } else {
            acc = fmaf(__uint_as_float(a[k]), __uint_as_float(r[k]), acc);
        }
    }
    return acc;
}

// ops/distance.py:_dist_bc, operation by operation
template <int METRIC>
__device__ __forceinline__ float distance(float dot, float qsq, float csq) {
    if constexpr (METRIC == 0) {   // cosine: 1 - dot / sqrt(max(q_sq c_sq, 1e-12))
        const float den = __fsqrt_rn(fmaxf(__fmul_rn(qsq, csq), 1e-12f));
        return __fsub_rn(1.f, __fdiv_rn(dot, den));
    } else if constexpr (METRIC == 1) {   // euclidean: sqrt(max(q_sq + c_sq - 2 dot, 0))
        return __fsqrt_rn(fmaxf(__fsub_rn(__fadd_rn(qsq, csq), __fmul_rn(2.f, dot)), 0.f));
    } else {   // dot: -dot
        return -dot;
    }
}

// rows[i] (int32, or int64 where rows64) clamped into [0, n_pad)
__device__ __forceinline__ int row_at(const void* rows, int rows64, long long i, int n_pad) {
    const long long r = rows64 ? __ldg(reinterpret_cast<const long long*>(rows) + i)
                               : (long long)__ldg(reinterpret_cast<const int*>(rows) + i);
    return r < 0 ? 0 : (r >= n_pad ? n_pad - 1 : (int)r);
}

template <typename T, int METRIC, int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_score_kernel(const float* __restrict__ queries, const float* __restrict__ q_sq,
                    const void* __restrict__ rows, int rows64, const T* __restrict__ vectors,
                    const float* __restrict__ v_sq, const unsigned char* __restrict__ valid,
                    float* __restrict__ out, int C, int N_pad, int chunks, int lanes_log) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int G = batch_steps(NC);
    uint4* q_s = reinterpret_cast<uint4*>(smem);
    int* list_slot = reinterpret_cast<int*>(smem + (size_t)chunks * 16);
    int* list_row = list_slot + kThreads;
    float* list_csq = reinterpret_cast<float*>(list_row + kThreads);
    int* warp_n = reinterpret_cast<int*>(list_csq + kThreads);

    const long long b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lanes = 1 << lanes_log;
    const int R = 32 >> lanes_log;                 // rows a warp-step
    const int slot = lane >> lanes_log, sub = lane & (lanes - 1);
    const int per_lane = (chunks + lanes - 1) >> lanes_log;
    const int passes = (per_lane + NC - 1) / NC;
    const long long D = (long long)chunks * Vals<T>::n;
    const float* qrow = queries + b * D;
    for (int c = threadIdx.x; c < chunks; c += kThreads) q_s[c] = load_query<T>(qrow, c);
    const float qsq = q_sq[b];
    const long long row0 = b * C;

#pragma unroll 1
    for (int base = 0; base < C; base += kThreads) {
        // this round's valid slots, compacted by a ballot prefix
        const int s = base + threadIdx.x;
        bool v = false;
        int r = 0;
        float csq = 0.f;
        if (s < C) {
            v = valid[row0 + s] != 0;
            if (v) {
                r = row_at(rows, rows64, row0 + s, N_pad);
                csq = __ldg(v_sq + r);
            } else {
                out[row0 + s] = kBig;
            }
        }
        const unsigned ballot = __ballot_sync(kFull, v);
        if (lane == 0) warp_n[warp] = __popc(ballot);
        __syncthreads();   // also publishes the query
        int n = 0, place = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int k = warp_n[w];
            place += w < warp ? k : 0;
            n += k;
        }
        if (v) {
            place += __popc(ballot & ((1u << lane) - 1u));
            list_slot[place] = s;
            list_row[place] = r;
            list_csq[place] = csq;
        }
        __syncthreads();

        // the list's rows, G warp-steps of a warp at once; j0 and the trip
        // counts are the same in every lane of a warp
#pragma unroll 1
        for (int j0 = warp * R * G; j0 < n; j0 += kWarps * R * G) {
            int rr[G];
            bool ok[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int j = j0 + g * R + slot;
                ok[g] = j < n;
                rr[g] = ok[g] ? list_row[j] : 0;
            }
            float acc[G];
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 1
            for (int ps = 0; ps < passes; ++ps) {
                const int c0 = sub + ps * NC * lanes;
                uint4 raw[G][NC];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const uint4* src = reinterpret_cast<const uint4*>(vectors + (long long)rr[g] * D);
#pragma unroll
                    for (int i = 0; i < NC; ++i) {
                        const int c = c0 + i * lanes;
                        raw[g][i] = ok[g] && c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
                    }
                }
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const int c = c0 + i * lanes;
                    if (c < chunks) {
                        const uint4 q = q_s[c];
#pragma unroll
                        for (int g = 0; g < G; ++g) acc[g] = dot_chunk<T>(q, raw[g][i], acc[g]);
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll 1
                for (int o = lanes >> 1; o > 0; o >>= 1) acc[g] += __shfl_xor_sync(kFull, acc[g], o);
            }
            if (sub == 0) {
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int j = j0 + g * R + slot;
                    if (ok[g]) out[row0 + list_slot[j]] = distance<METRIC>(acc[g], qsq, list_csq[j]);
                }
            }
        }
        if (base + kThreads < C) __syncthreads();   // before the list is refilled
    }
}

// ---------------------------------------------------------------------------
// The warp plan: rows of at most kWarpChunks chunks
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 128;         // threads a block (four warps)
constexpr int kWarpWarps = kWarpThreads / 32;
constexpr int kWarpSteps = 8;             // warp-steps whose loads go out at once
constexpr int kWarpChunks = 32;           // the widest row: one chunk a lane

// one 16-byte chunk of a row through the read-only path, leaving L1 to the
// ids, flags and query (each chunk of a slot's row is read once)
__device__ __forceinline__ uint4 load_chunk(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

// the position of the j-th (from 0) set bit of mask, for j < popc(mask)
__device__ __forceinline__ int nth_set_bit(unsigned mask, int j) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
        const int low = __popc(mask & ((1u << w) - 1u));
        if (j >= low) {
            j -= low;
            mask >>= w;
            pos += w;
        }
    }
    return pos;
}

// Halving exchanges of V values over the lanes at offsets OFF, 2 OFF, ...,
// V / 2 x OFF, largest first: a lane whose bit is set keeps the upper half
// of the values it holds and sends the lower half, its partner the reverse.
// v[0] is then the sum over those V lanes of the value whose index bit k is
// the lane's bit at offset OFF << k.
template <int V, int OFF>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
#pragma unroll
    for (int half = V / 2; half > 0; half /= 2) {
        const bool upper = (lane & (OFF * half)) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
            const float send = upper ? v[j] : v[half + j];
            const float keep = upper ? v[half + j] : v[j];
            v[j] = keep + __shfl_xor_sync(kFull, send, OFF * half);
        }
    }
}

// L lanes a row (its chunks rounded up to a power of two), 32 / L rows a
// warp-step; a warp takes slots 32 seg ... 32 seg + 31 of one query.
template <typename T, int METRIC, int L>
__global__ void __launch_bounds__(kWarpThreads)
gather_score_kernel_warp(const float* __restrict__ queries, const float* __restrict__ q_sq,
                         const void* __restrict__ rows, int rows64,
                         const T* __restrict__ vectors, const float* __restrict__ v_sq,
                         const unsigned char* __restrict__ valid, float* __restrict__ out,
                         int B, int C, int N_pad, int chunks) {
    constexpr int R = 32 / L;                           // rows a warp-step
    constexpr int G = L < kWarpSteps ? L : kWarpSteps;  // warp-steps a batch
    constexpr int NB = L / G;                           // batches
    const int segs = (C + 31) >> 5;                     // warps a query
    const long long w = (long long)blockIdx.x * kWarpWarps + (threadIdx.x >> 5);
    if (w >= (long long)B * segs) return;
    const long long b = w / segs;
    const int lane = threadIdx.x & 31;
    const int s = (int)(w - b * segs) * 32 + lane;      // the lane's slot
    const int p = lane & (R - 1), sub = lane / R;       // its row of a step, its chunk
    const long long D = (long long)chunks * Vals<T>::n;
    const long long at = b * C + s;

    // the slot's flag and id in one trip, the query's chunk and norm beside
    bool v = false;
    int r = 0;
    if (s < C) {
        v = valid[at] != 0;
        r = row_at(rows, rows64, at, N_pad);
    }
    const uint4 q = sub < chunks ? load_query<T>(queries + b * D, sub) : make_uint4(0u, 0u, 0u, 0u);
    const float qsq = q_sq[b];
    const unsigned ballot = __ballot_sync(kFull, v);
    const int n = __popc(ballot);
    // lane j: the row of the warp's j-th valid slot
    const int row_j = __shfl_sync(kFull, r, nth_set_bit(ballot, lane));
    const float csq = v ? __ldg(v_sq + r) : 0.f;

    // batches of G warp-steps, while any of their rows is valid (the same
    // in every lane): step t reads valid row t R + p at chunk sub; a batch's
    // loads all go out before its products, whose G sums are halved to one
    float part[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        part[nb] = 0.f;
        if (nb * G * R < n) {
            uint4 raw[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int j = (nb * G + g) * R + p;
                const int rr = __shfl_sync(kFull, row_j, j);
                raw[g] = j < n && sub < chunks
                             ? load_chunk(reinterpret_cast<const uint4*>(vectors + (long long)rr * D) + sub)
                             : make_uint4(0u, 0u, 0u, 0u);
            }
            float acc[G];
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] = dot_chunk<T>(q, raw[g], 0.f);
            halve<G, R>(acc, lane);
            part[nb] = acc[0];
        }
    }
    halve<NB, R * G>(part, lane);
    // lane j now holds the j-th valid row's sum; each slot's lane takes the
    // sum of its rank among the valid slots, and the warp stores its 32
    // slots at once
    const float dot = __shfl_sync(kFull, part[0], __popc(ballot & ((1u << lane) - 1u)));
    if (s < C) out[at] = v ? distance<METRIC>(dot, qsq, csq) : kBig;
}

// the lanes a row takes (log2): its chunks rounded up to a power of two, at
// most 32
inline int lanes_log_of(int chunks) {
    int l = 0;
    while ((1 << l) < chunks && l < 5) ++l;
    return l;
}

template <typename T, int METRIC, int L>
int launch_warp(const float* queries, const float* q_sq, const void* rows, int rows64,
                const T* vectors, const float* v_sq, const unsigned char* valid, float* out,
                int B, int C, int N_pad, int chunks, cudaStream_t st) {
    const long long warps = (long long)B * ((C + 31) / 32);
    gather_score_kernel_warp<T, METRIC, L>
        <<<(int)((warps + kWarpWarps - 1) / kWarpWarps), kWarpThreads, 0, st>>>(
            queries, q_sq, rows, rows64, vectors, v_sq, valid, out, B, C, N_pad, chunks);
    return (int)cudaGetLastError();
}

template <typename T, int METRIC>
int launch_metric(const float* queries, const float* q_sq, const void* rows, int rows64,
                  const T* vectors, const float* v_sq, const unsigned char* valid, float* out,
                  int B, int C, int N_pad, int chunks, cudaStream_t st) {
    const int lanes_log = lanes_log_of(chunks);
    if (chunks <= kWarpChunks) {
        auto launch = lanes_log == 0   ? launch_warp<T, METRIC, 1>
                      : lanes_log == 1 ? launch_warp<T, METRIC, 2>
                      : lanes_log == 2 ? launch_warp<T, METRIC, 4>
                      : lanes_log == 3 ? launch_warp<T, METRIC, 8>
                      : lanes_log == 4 ? launch_warp<T, METRIC, 16>
                                       : launch_warp<T, METRIC, 32>;
        return launch(queries, q_sq, rows, rows64, vectors, v_sq, valid, out, B, C, N_pad,
                      chunks, st);
    }
    // past kWarpChunks a lane takes at least two chunks of a row
    const int per_lane = (chunks + (1 << lanes_log) - 1) >> lanes_log;
    const int k = per_lane <= 2 ? 0 : per_lane <= 4 ? 1 : 2;
    auto kernel = k == 0   ? gather_score_kernel<T, METRIC, 2>
                  : k == 1 ? gather_score_kernel<T, METRIC, 4>
                           : gather_score_kernel<T, METRIC, 8>;
    const int smem = (int)shared_bytes(chunks);
    // shared memory above the 48 KB default (a wide query), set once per
    // device and instantiation, at an eager call (never inside a graph
    // capture)
    static bool sized[3][64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (smem > kDefaultSmem && (dev >= 64 || !sized[k][dev])) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) sized[k][dev] = true;
    }
    kernel<<<B, kThreads, smem, st>>>(queries, q_sq, rows, rows64, vectors, v_sq, valid, out, C,
                                      N_pad, chunks, lanes_log);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* queries, const void* q_sq, const void* rows, int rows64,
           const void* vectors, const void* v_sq, const void* valid, void* out, int B, int C,
           int N_pad, int D, int metric, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    if (N_pad <= 0 || D <= 0 || (D * (int)sizeof(T)) % 16 != 0 ||
        shared_bytes(D * (int)sizeof(T) / 16) > kSmemMax)
        return (int)cudaErrorInvalidValue;
    const int chunks = D * (int)sizeof(T) / 16;
    const float* q = (const float*)queries;
    const float* qs = (const float*)q_sq;
    const T* v = (const T*)vectors;
    const float* vs = (const float*)v_sq;
    const unsigned char* ok = (const unsigned char*)valid;
    float* o = (float*)out;
    const cudaStream_t st = (cudaStream_t)stream;
    if (metric == 0)
        return launch_metric<T, 0>(q, qs, rows, rows64, v, vs, ok, o, B, C, N_pad, chunks, st);
    if (metric == 1)
        return launch_metric<T, 1>(q, qs, rows, rows64, v, vs, ok, o, B, C, N_pad, chunks, st);
    return launch_metric<T, 2>(q, qs, rows, rows64, v, vs, ok, o, B, C, N_pad, chunks, st);
}

}  // namespace

// queries f32 [B, D], q_sq f32 [B], rows [B, C] (int32, or int64 where
// rows64), vectors [N_pad, D] (f32 or bf16), v_sq f32 [N_pad], valid bool
// [B, C]; writes out f32 [B, C]. metric: 0 cosine, 1 euclidean, 2 dot.
extern "C" int hop_gather_score_f32(const void* queries, const void* q_sq, const void* rows,
                                    int rows64, const void* vectors, const void* v_sq,
                                    const void* valid, void* out, int B, int C, int N_pad, int D,
                                    int metric, void* stream) {
    return launch<float>(queries, q_sq, rows, rows64, vectors, v_sq, valid, out, B, C, N_pad, D,
                         metric, stream);
}

extern "C" int hop_gather_score_bf16(const void* queries, const void* q_sq, const void* rows,
                                     int rows64, const void* vectors, const void* v_sq,
                                     const void* valid, void* out, int B, int C, int N_pad, int D,
                                     int metric, void* stream) {
    return launch<__nv_bfloat16>(queries, q_sq, rows, rows64, vectors, v_sq, valid, out, B, C,
                                 N_pad, D, metric, stream);
}

// the dynamic shared memory of a block for rows of D values of `bytes`
// bytes, or 0 where the rows are not whole 16-byte chunks or the query
// passes what a block may use
extern "C" int hop_gather_score_shared_bytes(int D, int bytes) {
    if (D <= 0 || bytes <= 0 || ((long long)D * bytes) % 16 != 0) return 0;
    const long long smem = shared_bytes((int)((long long)D * bytes / 16));
    return smem <= kSmemMax ? (int)smem : 0;
}

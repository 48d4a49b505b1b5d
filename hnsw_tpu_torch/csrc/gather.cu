// The HNSW search's candidate scoring where it reads rows, not a neighbour
// pack: each valid candidate's row gathered and dotted with the query in
// place, one block a query.
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
// the [B, C] output, and keeps enough rows in flight:
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
//   is the chunks a lane takes of a row in one pass (1, 2, 4 or 8), and a
//   wider row takes several passes. The query's chunks bound D
//   (hop_gather_score_shared_bytes is 0 past a block's shared memory).

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
__host__ __device__ constexpr int batch_steps(int nc) { return nc == 1 ? 8 : 16 / nc; }

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

// the lanes a row takes (log2): its chunks rounded up to a power of two, at
// most 32
inline int lanes_log_of(int chunks) {
    int l = 0;
    while ((1 << l) < chunks && l < 5) ++l;
    return l;
}

template <typename T, int METRIC>
int launch_metric(const float* queries, const float* q_sq, const void* rows, int rows64,
                  const T* vectors, const float* v_sq, const unsigned char* valid, float* out,
                  int B, int C, int N_pad, int chunks, cudaStream_t st) {
    const int lanes_log = lanes_log_of(chunks);
    const int per_lane = (chunks + (1 << lanes_log) - 1) >> lanes_log;
    const int k = per_lane <= 1 ? 0 : per_lane <= 2 ? 1 : per_lane <= 4 ? 2 : 3;
    auto kernel = k == 0   ? gather_score_kernel<T, METRIC, 1>
                  : k == 1 ? gather_score_kernel<T, METRIC, 2>
                  : k == 2 ? gather_score_kernel<T, METRIC, 4>
                           : gather_score_kernel<T, METRIC, 8>;
    const int smem = (int)shared_bytes(chunks);
    // shared memory above the 48 KB default (a wide query), set once per
    // device and instantiation, at an eager call (never inside a graph
    // capture)
    static bool sized[4][64];
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

// Greedy descent through the upper layers of an HNSW graph, one warp a query.
//
// Hand-written, with no pallas_call counterpart: it replaces the XLA
// lax.while_loop of hnsw_tpu/models/hnsw/search.py::_greedy_descent, which
// the reference runs once per upper layer inside its jitted search. Run as a
// host loop, that walk needs a host round trip a step to learn whether any
// query still improves; here every query walks all L layers inside one
// launch, so the search runs from seeding to result without the host.
//
// Contract. For query b, starting from (cur[b], cur_d[b]), for l = L-1 .. 0:
// until no neighbour improves,
//   nb = adj[l, cur, 0..M)
//   d[j] = distance(dot(round(q[b]), vectors[nb[j]]), q_sq[b], v_sq[nb[j]])
//          (BIG where nb[j] < 0)
//   j* = the first minimum of d (argmin's tie rule)
//   move to nb[j*] only if d[j*] < cur_d, strictly.
// The query is rounded to the dtype of `vectors` (bf16: round to nearest
// even, as astype does; f32: unchanged); products and sums are f32, so only
// the order of the sums differs from the plain version. distance() is
// ops/distance.py:_dist_bc for the metric, with no fused multiply-add.
// A query that stops improving is a no-op in the reference's batch loop, so
// a loop per query is that loop exactly.
//
// Bound on the H100: device-memory bytes, and in practice latency. A step
// reads one adjacency row (M ints) and then M rows of D values: two
// dependent loads, and a few steps a layer. Each query's walk is a chain of
// such steps, so the design keeps many walks in flight (one warp each, all
// of a batch of 1,024 resident at once) and starts a step's loads together:
// - Lanes are mapped to (row, 16-byte chunk) as in hop.cu: `lanes` lanes
//   share a row (its chunks rounded up to a power of two, at most 32), so a
//   warp-step scores 32 / lanes rows (four at D = 64 bf16, one at D = 768
//   with three chunks a lane).
// - The query slice of a lane's chunks is held in registers, rounded, for
//   the whole walk (NC chunks a lane, a template argument; NC = 0 reads it
//   per chunk for rows wider than 6 chunks a lane).
// - A batch of G warp-steps starts its adjacency loads, then all of its row
//   and norm loads, before the first product. G is 16 rows at NC = 1, 8 at
//   NC = 3 and 4 at NC = 6 (2 for bf16; a batch keeps 12-24 loads of 16
//   bytes in flight a lane, and the main path's M = 16 rows take one or two
//   batches); the
//   neighbourhood of one step is not loaded in one batch at D = 768,
//   where 48 loads a lane would spill.
// - Each row's sum is reduced over its lanes with xor shuffles, so every
//   lane of the row holds the same sum; the warp's first minimum is a
//   lexicographic (distance, row) minimum over the lanes, broadcast from
//   lane 0 so that the loop's control is uniform whatever the values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // queries a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;             // ops/distance.py BIG

// One launch's lane map (see the note above).
struct Plan {
    int chunks;    // 16-byte chunks of a row
    int lanes;     // lanes that share a row
    int per_lane;  // chunks a lane takes of each row
};

// warp-steps a batch loads at once, by chunks a lane and value bytes (six
// bf16 chunks hold 48 query values a lane, so they take two)
__host__ __device__ constexpr int batch_steps(int nc, int bytes) {
    return nc == 1 ? 16 : nc == 3 ? 8 : nc == 6 ? (bytes == 2 ? 2 : 4) : 8;
}

template <typename T> struct Vals { static constexpr int n = 16 / sizeof(T); };

// the values of one 16-byte chunk of a row, exactly as f32
template <typename T>
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[Vals<T>::n]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[2 * k] = __uint_as_float(w[k] << 16);
            v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
    }
}

// the query's values at one chunk of a row, rounded to T (zero past the row)
template <typename T>
__device__ __forceinline__ void load_query(const float* __restrict__ qrow, int c, int chunks,
                                           float (&q)[Vals<T>::n]) {
    constexpr int V = Vals<T>::n;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < chunks) x = __ldg(reinterpret_cast<const float4*>(qrow + (long long)c * V + j));
        q[j] = x.x;
        q[j + 1] = x.y;
        q[j + 2] = x.z;
        q[j + 3] = x.w;
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int j = 0; j < V; ++j) q[j] = __bfloat162float(__float2bfloat16_rn(q[j]));
    }
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

// (d, r, id) := the lexicographic minimum of (d, r) and (od, orow)
__device__ __forceinline__ void take_min(float& d, int& r, int& id, float od, int orow, int oid) {
    if (od < d || (od == d && orow < r)) {
        d = od;
        r = orow;
        id = oid;
    }
}

template <typename T, int METRIC, int NC>
__global__ void __launch_bounds__(kThreads)
descent_kernel(const float* __restrict__ queries, const float* __restrict__ q_sq,
               const int* __restrict__ cur_in, const float* __restrict__ d_in,
               const int* __restrict__ adj, const T* __restrict__ vectors,
               const float* __restrict__ v_sq, int* __restrict__ cur_out,
               float* __restrict__ d_out, int B, int L, int N_pad, int M, int D, Plan plan) {
    constexpr int V = Vals<T>::n;
    constexpr int G = batch_steps(NC, sizeof(T));
    constexpr int NCR = NC > 0 ? NC : 1;   // chunks held in registers
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= B) return;   // the whole warp leaves together
    const int sub = lane & (plan.lanes - 1);
    const int slot = lane / plan.lanes;
    const int R = 32 / plan.lanes;   // rows a warp-step
    const float* qrow = queries + (long long)b * D;

    float q[NCR][V];
    if constexpr (NC > 0) {
#pragma unroll
        for (int i = 0; i < NC; ++i) load_query<T>(qrow, sub + i * plan.lanes, plan.chunks, q[i]);
    }
    const float qsq = q_sq[b];
    int cur = cur_in[b];
    float cd = d_in[b];

    for (int l = L - 1; l >= 0; --l) {
        const int* adj_l = adj + (long long)l * N_pad * M;
        while (true) {
            const int at = cur < 0 ? 0 : (cur >= N_pad ? N_pad - 1 : cur);
            const int* nbrow = adj_l + (long long)at * M;
            float best_d = kBig;
            int best_r = 0x7fffffff, best_id = -1;
            for (int r0 = 0; r0 < M; r0 += G * R) {
                int id[G];
                float csq[G], acc[G];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int r = r0 + g * R + slot;
                    id[g] = r < M ? __ldg(nbrow + r) : -1;
                }
                const uint4* src[G];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int row = id[g] < 0 ? 0 : (id[g] >= N_pad ? N_pad - 1 : id[g]);
                    src[g] = reinterpret_cast<const uint4*>(vectors + (long long)row * D);
                    csq[g] = id[g] >= 0 ? __ldg(v_sq + row) : 0.f;
                    acc[g] = 0.f;
                }
                // NC = 0: one chunk a pass, its query values read per pass
                const int passes = NC > 0 ? 1 : plan.per_lane;
                for (int p = 0; p < passes; ++p) {
                    if constexpr (NC == 0) load_query<T>(qrow, sub + p * plan.lanes, plan.chunks, q[0]);
                    uint4 raw[G][NCR];
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int i = 0; i < NCR; ++i) {
                            const int c = sub + (NC > 0 ? i : p) * plan.lanes;
                            raw[g][i] = (id[g] >= 0 && c < plan.chunks) ? __ldg(src[g] + c)
                                                                         : make_uint4(0u, 0u, 0u, 0u);
                        }
#pragma unroll
                    for (int i = 0; i < NCR; ++i)
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            float v[V];
                            unpack<T>(raw[g][i], v);
#pragma unroll
                            for (int j = 0; j < V; ++j)
                                acc[g] = fmaf(q[i][j], v[j], acc[g]);
                        }
                }
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    for (int o = plan.lanes >> 1; o > 0; o >>= 1)
                        acc[g] += __shfl_xor_sync(kFull, acc[g], o);
                    const int r = r0 + g * R + slot;
                    if (r < M)
                        take_min(best_d, best_r, best_id,
                                 id[g] >= 0 ? distance<METRIC>(acc[g], qsq, csq[g]) : kBig, r, id[g]);
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const float od = __shfl_xor_sync(kFull, best_d, o);
                const int orow = __shfl_xor_sync(kFull, best_r, o);
                const int oid = __shfl_xor_sync(kFull, best_id, o);
                take_min(best_d, best_r, best_id, od, orow, oid);
            }
            best_d = __shfl_sync(kFull, best_d, 0);
            best_id = __shfl_sync(kFull, best_id, 0);
            if (!(best_d < cd)) break;
            cur = best_id;
            cd = best_d;
        }
    }
    if (lane == 0) {
        cur_out[b] = cur;
        d_out[b] = cd;
    }
}

template <typename T, int METRIC>
void launch_metric(const float* queries, const float* q_sq, const int* cur_in, const float* d_in,
                   const int* adj, const T* vectors, const float* v_sq, int* cur_out,
                   float* d_out, int B, int L, int N_pad, int M, int D, Plan plan,
                   cudaStream_t st) {
    const int grid = (B + kWarps - 1) / kWarps;
    auto kernel = plan.per_lane <= 1   ? descent_kernel<T, METRIC, 1>
                  : plan.per_lane <= 3 ? descent_kernel<T, METRIC, 3>
                  : plan.per_lane <= 6 ? descent_kernel<T, METRIC, 6>
                                       : descent_kernel<T, METRIC, 0>;
    kernel<<<grid, kThreads, 0, st>>>(queries, q_sq, cur_in, d_in, adj, vectors, v_sq, cur_out,
                                      d_out, B, L, N_pad, M, D, plan);
}

template <typename T>
int launch(const void* queries, const void* q_sq, const void* cur_in, const void* d_in,
           const void* adj, const void* vectors, const void* v_sq, void* cur_out, void* d_out,
           int B, int L, int N_pad, int M, int D, int metric, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    Plan plan;
    plan.chunks = D * (int)sizeof(T) / 16;
    plan.lanes = 1;
    while (plan.lanes < plan.chunks && plan.lanes < 32) plan.lanes *= 2;
    plan.per_lane = (plan.chunks + plan.lanes - 1) / plan.lanes;
    const float* q = (const float*)queries;
    const float* qs = (const float*)q_sq;
    const int* ci = (const int*)cur_in;
    const float* di = (const float*)d_in;
    const int* a = (const int*)adj;
    const T* v = (const T*)vectors;
    const float* vs = (const float*)v_sq;
    int* co = (int*)cur_out;
    float* dout = (float*)d_out;
    const cudaStream_t st = (cudaStream_t)stream;
    if (metric == 0)
        launch_metric<T, 0>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
    else if (metric == 1)
        launch_metric<T, 1>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
    else
        launch_metric<T, 2>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
    return (int)cudaGetLastError();
}

}  // namespace

// queries f32 [B, D], q_sq f32 [B], cur int32 [B], cur_d f32 [B], adj int32
// [L, N_pad, M], vectors [N_pad, D] (bf16 or f32), v_sq f32 [N_pad]; writes
// cur_out int32 [B] and d_out f32 [B]. metric: 0 cosine, 1 euclidean, 2 dot.
extern "C" int greedy_descent_bf16(const void* queries, const void* q_sq, const void* cur_in,
                                   const void* d_in, const void* adj, const void* vectors,
                                   const void* v_sq, void* cur_out, void* d_out, int B, int L,
                                   int N_pad, int M, int D, int metric, void* stream) {
    return launch<__nv_bfloat16>(queries, q_sq, cur_in, d_in, adj, vectors, v_sq, cur_out, d_out,
                                 B, L, N_pad, M, D, metric, stream);
}

extern "C" int greedy_descent_f32(const void* queries, const void* q_sq, const void* cur_in,
                                  const void* d_in, const void* adj, const void* vectors,
                                  const void* v_sq, void* cur_out, void* d_out, int B, int L,
                                  int N_pad, int M, int D, int metric, void* stream) {
    return launch<float>(queries, q_sq, cur_in, d_in, adj, vectors, v_sq, cur_out, d_out, B, L,
                         N_pad, M, D, metric, stream);
}

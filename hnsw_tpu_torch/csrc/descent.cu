// Greedy descent through the upper layers of an HNSW graph, one block a query.
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
// `cur` and the neighbour ids are clamped into [0, N_pad) where they index
// a row. A query that stops improving is a no-op in the reference's batch
// loop, so a loop per query is that loop exactly.
//
// Bound on the H100: latency. A step reads one neighbourhood (M rows of D
// values, 24 KiB at M = 16, D = 768 bf16) chosen by the step before, so a
// walk is a chain of dependent steps and the kernel lasts at least its
// longest walk; at a batch of 1,024 the walks also move about 0.5 GB,
// mostly from L2 (the upper layers' rows fit there). The design gives each
// step one dependent round trip with the whole neighbourhood in flight,
// and keeps the work between two round trips short:
// - A block of kWarps warps walks one query; its control (the node, the
//   layer) is the same in every thread.
// - Ahead. When a step's neighbour ids are on chip (in shared memory), the
//   block issues together the M neighbour rows, their norms, each
//   neighbour's adjacency row on this layer (M x M ids) and this node's row
//   on the layer below, the ids with cp.async (16-byte pieces where M is a
//   multiple of 4; thread t takes pieces t, t + kThreads, ..., stepped
//   without a division). After the argmin the next step's ids are on chip,
//   whether the walk moves (neighbour j*'s row) or drops a layer, and its
//   row loads go out at once. The ids sit in two buffers that the steps
//   alternate. Where M x M ids would not fit, the next row is fetched after
//   the argmin (`ahead` 0: a second round trip a step).
// - The rows. Each lane loads its chunks of its warp's rows straight into
//   registers, all G warp-steps at once (four rows a warp and 12 loads of
//   16 bytes a lane at M = 16, D = 768 bf16: the whole neighbourhood in
//   flight), through L1, where the upper layers' shared rows hit. This is
//   faster at B = 1,024 and at B = 32 than bulk copies of the rows into
//   shared memory on an mbarrier, although its 118 registers hold four
//   queries an SM where the copies' 64 held eight (PERF.md, section 6).
// - Scoring. Lanes are mapped to (row, 16-byte chunk): `lanes` lanes share
//   a row (its chunks rounded up to a power of two, at least kMinLanes, at
//   most 32), 32 / lanes rows a warp-step, each lane taking chunks sub,
//   sub + lanes, ...; warp w takes the warp-steps w, w + kWarps, ..., G at
//   a time. The query slice of a lane's chunks is held in registers,
//   rounded and packed as the rows are (NC chunks a lane; NC = 0 reads it
//   per chunk for rows wider than 6 chunks a lane). Each row's sum is
//   reduced over its lanes by halving: at the first log2 G shuffle levels a
//   lane keeps the half of the G rows its lane bit names and trades the
//   other half, so log2 lanes levels reduce G rows, every array index is a
//   constant (nothing goes to local memory) and each row ends in lanes of
//   its own, the first of which computes the row's distance, once, as a
//   key whose unsigned order is the float's.
// - The argmin. After the step's one __syncthreads (which also publishes
//   the prefetched ids), every warp reads the M keys and ids (two buffers
//   by step parity) and takes the first minimum by (distance, row) with two
//   warp min-reductions (redux.sync: the smallest key, then the smallest
//   row of that key), so every thread reaches the same move.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps a query (a block)
constexpr int kThreads = 32 * kWarps;
// blocks an SM must hold (the launch bounds): ptxas then has 128 registers
// a thread, and uses about 118 at D = 768 bf16
constexpr int kMinBlocks = 4;
constexpr int kSmemMax = 232448;          // shared memory a block can have
constexpr int kMinLanes = 4;              // lanes a row at least: the G rows a lane-group halves
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;             // ops/distance.py BIG

// One launch's plan. Shared memory: two buffers (by step parity) of the
// rows' distance keys and ids, then from ids_off two buffers of id rows
// (`ahead`: M + 1 rows of M each, else one).
struct Plan {
    int chunks;    // 16-byte chunks of a row
    int lanes;     // lanes that share a row
    int per_lane;  // chunks a lane takes of each row
    int ahead;     // 1: the next step's ids are fetched with the step's rows
    int ids_off;   // byte offset of the id buffers
    int smem;      // dynamic shared memory of a block
    int vec;       // the id rows move in 16-byte pieces of 4 ids, else 1
    int per_row;   // pieces of an id row
    int dk, dc;    // kThreads pieces on, in rows and pieces
};

// warp-steps a warp scores at once, by chunks a lane and value bytes:
// enough that a warp's share of the neighbourhood is in flight (four rows,
// 12 loads of 16 bytes a lane at D = 768 bf16)
__host__ __device__ constexpr int batch_steps(int nc, int bytes) {
    return nc == 6 ? (bytes == 2 ? 1 : 2) : 4;
}

template <typename T> struct Vals { static constexpr int n = 16 / sizeof(T); };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int clamp_row(int row, int n_pad) {
    return row < 0 ? 0 : (row >= n_pad ? n_pad - 1 : row);
}

// `count` rows of M ids into dst[k * M ..], row k from global src(k), with
// cp.async in pieces of `w` ids (4, 16 bytes, where M is a multiple of 4;
// else 1), plan.per_row to a row; piece i of the rows goes to thread
// i % kThreads. `first` is the thread's first piece (its row << 16 | its
// piece there), and the plan's (dk, dc) is kThreads pieces on, so the loop
// divides nothing.
template <typename Src>
__device__ __forceinline__ void fetch_ids(int* dst, int count, int M, const Plan& plan, int first,
                                          Src src) {
    int k = first >> 16, c = first & 0xffff;
#pragma unroll 1
    while (k < count) {
        if (plan.vec)
            cp_async<16>(dst + k * M + 4 * c, src(k) + 4 * c);
        else
            cp_async<4>(dst + k * M + c, src(k) + c);
        k += plan.dk;
        c += plan.dc;
        if (c >= plan.per_row) {
            c -= plan.per_row;
            ++k;
        }
    }
}

// the query's values at one chunk of a row, rounded to T (zero past the
// row), in the row's layout: four f32, or eight bf16 in pairs (the first in
// the low half), which are exact, since the query is rounded to bf16
template <typename T>
__device__ __forceinline__ uint4 load_query(const float* __restrict__ qrow, int c, int chunks) {
    constexpr int V = Vals<T>::n;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; j += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < chunks) x = __ldg(reinterpret_cast<const float4*>(qrow + (long long)c * V + j));
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
// by value in order, in f32 (a bf16 value is its f32 value's high half)
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

// a key whose unsigned order is the float order (NaN last, -0 as +0)
__device__ __forceinline__ uint32_t order_key(float d) {
    const uint32_t u = __float_as_uint(d + 0.f);
    return d != d ? 0xffffffffu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the rows of G warp-steps from s0 that a lane scores (warp-step s0 + g
// kWarps, the lane's slot in it), their ids (-1 past the M rows) and norms
template <int G>
__device__ __forceinline__ void rows_of(int s0, int R, int slot, int M, const int* ids,
                                        const float* __restrict__ v_sq, int N_pad,
                                        int (&id)[G], int (&rr)[G], float (&csq)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
        rr[g] = (s0 + g * kWarps) * R + slot;
        id[g] = rr[g] < M ? ids[rr[g]] : -1;
        csq[g] = id[g] >= 0 ? __ldg(v_sq + clamp_row(id[g], N_pad)) : 0.f;
    }
}

template <typename T, int METRIC, int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
descent_block_kernel(const float* __restrict__ queries, const float* __restrict__ q_sq,
                     const int* __restrict__ cur_in, const float* __restrict__ d_in,
                     const int* __restrict__ adj, const T* __restrict__ vectors,
                     const float* __restrict__ v_sq, int* __restrict__ cur_out,
                     float* __restrict__ d_out, int L, int N_pad, int M, int D, Plan plan) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int G = batch_steps(NC, sizeof(T));
    constexpr int NCR = NC > 0 ? NC : 1;   // chunks held in registers
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sub = lane & (plan.lanes - 1);
    const int rlog = 6 - __ffs(plan.lanes);   // log2 of the rows a warp-step
    const int slot = lane >> (5 - rlog);
    const int R = 1 << rlog;
    const int wsteps = (M + R - 1) >> rlog;
    const float* qrow = queries + (long long)b * D;
    // two buffers, by step parity, of each row's distance key and id
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
    int* kid = reinterpret_cast<int*>(keys + 2 * M);
    int* ids_buf = reinterpret_cast<int*>(smem + plan.ids_off);
    const int slots = plan.ahead ? M + 1 : 1;
    const int down = plan.ahead ? M : 0;   // the row of the layer below

    uint4 q[NCR];
    if constexpr (NC > 0) {
#pragma unroll
        for (int i = 0; i < NC; ++i) q[i] = load_query<T>(qrow, sub + i * plan.lanes, plan.chunks);
    }
    const float qsq = q_sq[b];
    int cur = cur_in[b];
    float cd = d_in[b];
    int l = L - 1;

    const int first = ((int)threadIdx.x / plan.per_row) << 16 | (int)threadIdx.x % plan.per_row;
    {   // the first step's ids: adj[L-1, cur]
        const int* src = adj + ((long long)l * N_pad + clamp_row(cur, N_pad)) * M;
        fetch_ids(ids_buf + down * M, 1, M, plan, first, [&](int) { return src; });
    }
    cp_async_wait_all();
    __syncthreads();

    const int* ids = ids_buf + down * M;
    int p = 0;
    while (true) {
        // the query's words are opaque to the compiler at each step, so it
        // keeps them packed rather than holding their values unpacked
#pragma unroll
        for (int i = 0; i < NCR; ++i)
            asm volatile("" : "+r"(q[i].x), "+r"(q[i].y), "+r"(q[i].z), "+r"(q[i].w));
        int* next = ids_buf + (p ^ 1) * slots * M;
        const int* adj_l = adj + (long long)l * N_pad * M;
        uint32_t* key_p = keys + p * M;
        int* kid_p = kid + p * M;
        if (plan.ahead) {
            // the next step's ids: each neighbour's row on this layer, and
            // this node's on the layer below
            const int* below = adj_l - (long long)N_pad * M + (long long)clamp_row(cur, N_pad) * M;
            fetch_ids(next, l > 0 ? M + 1 : M, M, plan, first, [&](int k) {
                return k < M ? adj_l + (long long)clamp_row(ids[k], N_pad) * M : below;
            });
        }
        // the rows of the warp's warp-steps, G at a time
        int id[G], rr[G];
        float csq[G];
#pragma unroll 1
        for (int s0 = warp; s0 < wsteps; s0 += kWarps * G) {
            rows_of<G>(s0, R, slot, M, ids, v_sq, N_pad, id, rr, csq);
            float acc[G];
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] = 0.f;
            // NC = 0: one chunk a pass, its query values read per pass
            const int passes = NC > 0 ? 1 : plan.per_lane;
#pragma unroll 1
            for (int ps = 0; ps < passes; ++ps) {
                if constexpr (NC == 0) q[0] = load_query<T>(qrow, sub + ps * plan.lanes, plan.chunks);
                uint4 raw[G][NCR];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const uint4* src =
                        reinterpret_cast<const uint4*>(vectors + (long long)clamp_row(id[g], N_pad) * D);
#pragma unroll
                    for (int i = 0; i < NCR; ++i) {
                        const int c = sub + (NC > 0 ? i : ps) * plan.lanes;
                        const bool ok = id[g] >= 0 && c < plan.chunks;
                        raw[g][i] = ok ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
                    }
                }
#pragma unroll
                for (int i = 0; i < NCR; ++i)
#pragma unroll
                    for (int g = 0; g < G; ++g) acc[g] = dot_chunk<T>(q[i], raw[g][i], acc[g]);
            }
            // each row's sum over its lanes, halving: at the first levels a
            // lane keeps the half of the G rows its lane bit names and
            // trades the other half with its partner, so the lanes
            // sub / (lanes / G) == g end with row g's sum (and its id, norm
            // and place), and the rest of the levels add
#pragma unroll
            for (int half = G / 2, o = plan.lanes >> 1; half >= 1; half >>= 1, o >>= 1) {
                const bool up = sub & o;
#pragma unroll
                for (int j = 0; j < half; ++j) {
                    const float send = up ? acc[j] : acc[j + half];
                    acc[j] = (up ? acc[j + half] : acc[j]) + __shfl_xor_sync(kFull, send, o);
                    id[j] = up ? id[j + half] : id[j];
                    rr[j] = up ? rr[j + half] : rr[j];
                    csq[j] = up ? csq[j + half] : csq[j];
                }
            }
#pragma unroll 1
            for (int o = plan.lanes / (2 * G); o > 0; o >>= 1)
                acc[0] += __shfl_xor_sync(kFull, acc[0], o);
            // the first lane of each row computes its distance, once, as a
            // key whose order is the float's
            if ((sub & (plan.lanes / G - 1)) == 0 && rr[0] < M) {
                key_p[rr[0]] = order_key(id[0] >= 0 ? distance<METRIC>(acc[0], qsq, csq[0]) : kBig);
                kid_p[rr[0]] = id[0];
            }
        }
        cp_async_wait_all();
        __syncthreads();
        // every warp takes the first minimum by (distance, row), as two
        // warp min-reductions (the smallest key, then its smallest row),
        // so every thread reaches the same move
        uint32_t key = 0xffffffffu;
        int br = 0x7fffffff;
#pragma unroll 1
        for (int j = lane; j < M; j += 32)
            if (key_p[j] < key || br == 0x7fffffff) {
                key = key_p[j];
                br = j;
            }
        const uint32_t kmin = __reduce_min_sync(kFull, key);
        const uint32_t rmin = __reduce_min_sync(kFull, key == kmin ? (uint32_t)br : 0xffffffffu);
        const float best_d = key_value(kmin);
        const bool move = rmin < (uint32_t)M && best_d < cd;   // strictly nearer
        if (move) {
            cur = kid_p[rmin];
            cd = best_d;
        } else if (l == 0) {
            break;
        } else {
            --l;
        }
        if (plan.ahead) {
            ids = next + (move ? (int)rmin : down) * M;
        } else {
            const int* src = adj + ((long long)l * N_pad + clamp_row(cur, N_pad)) * M;
            fetch_ids(next, 1, M, plan, first, [&](int) { return src; });
            cp_async_wait_all();
            __syncthreads();
            ids = next;
        }
        p ^= 1;
    }
    if (threadIdx.x == 0) {
        cur_out[b] = cur;
        d_out[b] = cd;
    }
}

// smem 0 where no plan fits
Plan make_plan(int M, int D, int bytes) {
    Plan p;
    p.chunks = D * bytes / 16;
    p.lanes = kMinLanes;
    while (p.lanes < p.chunks && p.lanes < 32) p.lanes *= 2;
    p.per_lane = (p.chunks + p.lanes - 1) / p.lanes;
    p.vec = (M & 3) == 0;
    p.per_row = p.vec ? M / 4 : M;
    p.dk = kThreads / p.per_row;
    p.dc = kThreads - p.dk * p.per_row;
    p.ids_off = 16 * M;
    p.smem = 0;
    for (p.ahead = 1; p.ahead >= 0; --p.ahead) {
        const long long smem = p.ids_off + 2LL * (p.ahead ? M + 1 : 1) * M * 4;
        if (smem <= kSmemMax) {
            p.smem = (int)smem;
            return p;
        }
    }
    p.ahead = 0;
    return p;
}

template <typename T, int METRIC>
int launch_metric(const float* queries, const float* q_sq, const int* cur_in, const float* d_in,
                  const int* adj, const T* vectors, const float* v_sq, int* cur_out, float* d_out,
                  int B, int L, int N_pad, int M, int D, const Plan& plan, cudaStream_t st) {
    const int k = plan.per_lane <= 1 ? 0 : plan.per_lane <= 3 ? 1 : plan.per_lane <= 6 ? 2 : 3;
    auto kernel = k == 0   ? descent_block_kernel<T, METRIC, 1>
                  : k == 1 ? descent_block_kernel<T, METRIC, 3>
                  : k == 2 ? descent_block_kernel<T, METRIC, 6>
                           : descent_block_kernel<T, METRIC, 0>;
    // shared memory above the 48 KB default (a large M's id rows), set once
    // per device and instantiation, at an eager call (never inside a graph
    // capture)
    static bool sized[4][64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !sized[k][dev]) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemMax - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) sized[k][dev] = true;
    }
    kernel<<<B, kThreads, plan.smem, st>>>(queries, q_sq, cur_in, d_in, adj, vectors, v_sq,
                                           cur_out, d_out, L, N_pad, M, D, plan);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* queries, const void* q_sq, const void* cur_in, const void* d_in,
           const void* adj, const void* vectors, const void* v_sq, void* cur_out, void* d_out,
           int B, int L, int N_pad, int M, int D, int metric, void* stream) {
    if (B <= 0 || L <= 0) return (int)cudaGetLastError();
    Plan plan = make_plan(M, D, (int)sizeof(T));
    if (plan.smem == 0) return (int)cudaErrorInvalidValue;
    // a view of adj off a 16-byte boundary moves its ids 4 bytes at a time
    if (plan.vec && (reinterpret_cast<uintptr_t>(adj) & 15) != 0) {
        plan.vec = 0;
        plan.per_row = M;
        plan.dk = kThreads / M;
        plan.dc = kThreads - plan.dk * M;
    }
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
        return launch_metric<T, 0>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
    if (metric == 1)
        return launch_metric<T, 1>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
    return launch_metric<T, 2>(q, qs, ci, di, a, v, vs, co, dout, B, L, N_pad, M, D, plan, st);
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

// the dynamic shared memory of a block for M neighbours of rows of D values
// of `bytes` bytes, or 0 where the kernel cannot take that M
extern "C" int greedy_descent_shared_bytes(int M, int D, int bytes) {
    return M > 0 ? make_plan(M, D, bytes).smem : 0;
}

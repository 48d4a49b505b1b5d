// The beam update of the HNSW hop body: the stable merge of the body's
// scored candidates into the beam, and the next body's select on the merged
// beam, one block a query.
//
// Hand-written, with no pallas_call counterpart: it replaces the XLA ops of
// the reference's hop body (hnsw_tpu/models/hnsw/search.py: the select's
// cumsum, amin, stop rule and one-hot, and _beam_merge's one-key lax.sort),
// which the port ran as about twenty PyTorch operators a body: three cats, a
// stable radix sort of [B, ef + C] keys, a gather, a cumsum, a [B, E, ef]
// one-hot and its amax, a launch each. The select belongs to the next body,
// but it reads only the merged beam, which this block already holds in
// shared memory; so one launch does both, and one launch with no candidates
// (C = 0) makes the first body's select before the loop.
//
// Contract. For query b, the beam (d, id, exp) [ef] and the candidates
// (cd, cid) [C] (C may be 0; candidates enter with exp = false):
//   merge   the new beam is the first ef entries of the stable ascending
//           sort of [beam ++ candidates] by d: equal keys keep their order,
//           the beam's before the candidates', a lower slot first. Keys
//           compare as floats, so -0.0 equals 0.0; a NaN sorts after every
//           number. The beam need not be ascending on entry (multi-entry
//           seeds leave BIG holes between sorted seeds).
//   select  elig = !exp && id >= 0 on the new beam; sel_d0 = the least
//           eligible d (NaN where an eligible d is NaN, BIG where none is
//           eligible); active' = active && sel_d0 < BIG && sel_d0 <=
//           d[ef - 1]. Where active', the first E eligible slots in slot
//           order are taken: sel[r] is the r-th taken id, -1 past the last,
//           and exp |= take.
// The results are torch.sort's and the plain operators' bit for bit.
//
// Bound on the H100: launch latency. At B = 1,024, ef = 200, C = 128 the
// work reads the beam (1.8 MB) and the candidates (1.0 MB) and writes the
// beam and sel (1.9 MB): about 5 MB, 1.5 us at 3.35 TB/s; its compares (a
// candidate's rank among C candidates, two binary searches a slot) are about
// a microsecond of the card. The design:
// - A block of round_up(max(ef, C), 32) threads (at most kMaxThreads,
//   stepping over the slots beyond) takes one query and stages the beam and
//   the candidates in shared memory, each d beside an order key (the float's
//   bits mapped so that unsigned order is float order).
// - A candidate's stable rank among the candidates comes from C compares
//   with warp-uniform broadcast reads, four keys a 16-byte read (the keys
//   padded with the largest, which no rank counts); it writes its key at
//   that rank, so the candidates' keys lie sorted. A candidate's place in
//   the merge is its rank plus the beam keys <= its key; a beam slot's is
//   its slot plus the candidate keys < its key: two branch-free binary
//   searches. A beam found not ascending (one __syncthreads_and) ranks each
//   slot by ef compares. Each entry placed below ef is written once into
//   the new beam.
// - The select: the first eligible slot by an atomicMin in shared memory,
//   then a ballot-and-popc prefix over the new beam, chunk by chunk of the
//   block's width; each thread writes its slot of the beam out once. Where
//   ef and C fit the block, a call takes four barriers.
// - Any B, E, ef and C: the shapes come from the arguments; an ef + C whose
//   shared memory passes kSmemMax is refused (hop_merge_shared_bytes is 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
// the shared memory a block may use on Hopper (227 KB)
constexpr int kSmemMax = 232448;
constexpr int kDefaultSmem = 48 * 1024;
// ops/distance.py's BIG as the float32 the plain operators compare with
constexpr float kBig = 1e30f;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// a block's shared memory: the beam's key, d and id, the new beam's d and
// id (five words a slot), the candidates' key, d, id, rank and sorted key
// (five words a candidate), 32 warp counts and the first eligible slot, then
// the beam's and the new beam's exp flags (a byte each)
__host__ inline long long shared_bytes(int ef, int C) {
    return (long long)round4(ef) * (5 * 4 + 2) + (long long)round4(C) * 5 * 4 + 33 * 4;
}

// unsigned order = float order, with -0.0 == 0.0 and every NaN last
__device__ inline unsigned order_key(float f) {
    unsigned u = __float_as_uint(f);
    if (f != f) return 0xffffffffu;
    if (u == 0x80000000u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the number of ascending keys[0, n) below k (kStrict) or at most k, by
// binary lifting: the same trip count in every lane
template <bool kStrict>
__device__ inline int count_below(const unsigned* keys, int n, unsigned k) {
    int pos = 0;
    for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
        const int next = pos + step;
        if (next <= n) {
            const unsigned v = keys[next - 1];
            if (kStrict ? v < k : v <= k) pos = next;
        }
    }
    return pos;
}

__global__ void __launch_bounds__(kMaxThreads)
    hop_merge_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_ids,
                     const bool* __restrict__ beam_exp, const float* __restrict__ cand_d,
                     const int* __restrict__ cand_ids, const bool* __restrict__ active,
                     float* __restrict__ out_d, int* __restrict__ out_ids,
                     bool* __restrict__ out_exp, int* __restrict__ sel,
                     bool* __restrict__ out_active, int ef, int C, int E) {
    extern __shared__ int4 smem[];
    const int e4 = round4(ef), c4 = round4(C);
    unsigned* bk = reinterpret_cast<unsigned*>(smem);
    float* bd = reinterpret_cast<float*>(bk + e4);
    int* bid = reinterpret_cast<int*>(bd + e4);
    float* od = reinterpret_cast<float*>(bid + e4);
    int* oid = reinterpret_cast<int*>(od + e4);
    unsigned* ck = reinterpret_cast<unsigned*>(oid + e4);
    float* cd = reinterpret_cast<float*>(ck + c4);
    int* cid = reinterpret_cast<int*>(cd + c4);
    int* crank = cid + c4;
    unsigned* cs = reinterpret_cast<unsigned*>(crank + c4);
    int* wcount = reinterpret_cast<int*>(cs + c4);
    int* first = wcount + 32;
    unsigned char* bexp = reinterpret_cast<unsigned char*>(first + 1);
    unsigned char* oexp = bexp + e4;

    const long long b = blockIdx.x;
    const int tid = threadIdx.x, nt = blockDim.x;

    for (int t = tid; t < ef; t += nt) {
        const float d = beam_d[b * ef + t];
        bd[t] = d;
        bk[t] = order_key(d);
        bid[t] = beam_ids[b * ef + t];
        bexp[t] = beam_exp[b * ef + t];
    }
    for (int j = tid; j < C; j += nt) {
        const float d = cand_d[b * C + j];
        cd[j] = d;
        ck[j] = order_key(d);
        cid[j] = cand_ids[b * C + j];
    }
    // the largest key pads the candidates' to a multiple of four: no rank
    // counts it
    for (int j = C + tid; j < c4; j += nt) ck[j] = 0xffffffffu;
    if (tid == 0) *first = ef;
    __syncthreads();

    // each candidate's stable rank among the candidates, and its key stored
    // at that rank; whether the beam is ascending
    const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
    int ascending = 1;
    for (int t = tid; t + 1 < ef; t += nt) ascending &= bk[t] <= bk[t + 1];
    const uint4* ck4 = reinterpret_cast<const uint4*>(ck);
    // j0, the warp's first candidate, is the same in every lane, and so is
    // each loop's trip count: a key before the warp's candidates counts where
    // it is <= kj, one after them where it is < kj, and one of the warp's
    // own by both tests
    for (int j0 = tid - lane; j0 < C; j0 += nt) {
        const int j = j0 + lane, own = min(j0 + 32, c4);
        const unsigned kj = j < C ? ck[j] : 0u;
        int r = 0;
#pragma unroll 1
        for (int i = 0; i < j0; i += 4) {
            const uint4 v = ck4[i / 4];
            r += (v.x <= kj) + (v.y <= kj) + (v.z <= kj) + (v.w <= kj);
        }
#pragma unroll 1
        for (int i = j0; i < own; i += 4) {
            const uint4 v = ck4[i / 4];
            r += (v.x < kj) | ((v.x == kj) & (i < j));
            r += (v.y < kj) | ((v.y == kj) & (i + 1 < j));
            r += (v.z < kj) | ((v.z == kj) & (i + 2 < j));
            r += (v.w < kj) | ((v.w == kj) & (i + 3 < j));
        }
#pragma unroll 1
        for (int i = own; i < c4; i += 4) {
            const uint4 v = ck4[i / 4];
            r += (v.x < kj) + (v.y < kj) + (v.z < kj) + (v.w < kj);
        }
        if (j < C) {
            crank[j] = r;
            cs[r] = kj;
        }
    }
    ascending = __syncthreads_and(ascending);

    // the merge: each entry's place, written where it is below ef
    for (int j = tid; j < C; j += nt) {
        const int r = crank[j];
        if (r >= ef) continue;
        const unsigned kj = ck[j];
        int place = r;
        if (ascending) {
            place += count_below<false>(bk, ef, kj);
        } else {
            for (int t = 0; t < ef; ++t) place += bk[t] <= kj;
        }
        if (place < ef) {
            od[place] = cd[j];
            oid[place] = cid[j];
            oexp[place] = 0;
        }
    }
    for (int t = tid; t < ef; t += nt) {
        const unsigned kt = bk[t];
        int place = t;
        if (!ascending) {
            place = 0;
            for (int u = 0; u < ef; ++u) {
                const unsigned ku = bk[u];
                place += (ku < kt) | ((ku == kt) & (u < t));
            }
        }
        place += count_below<true>(cs, C, kt);
        if (place < ef) {
            od[place] = bd[t];
            oid[place] = bid[t];
            oexp[place] = bexp[t];
        }
    }
    __syncthreads();

    // the select: the first eligible slot holds the least eligible d; one
    // barrier ends its atomicMin and the first chunk's warp counts
    int mine = ef, nan = 0;
    for (int t = tid; t < ef; t += nt) {
        if (!oexp[t] && oid[t] >= 0) {
            mine = min(mine, t);
            nan |= od[t] != od[t];
        }
    }
    if (mine < ef) atomicMin(first, mine);
    bool elig = tid < ef && !oexp[tid] && oid[tid] >= 0;
    unsigned m = __ballot_sync(0xffffffffu, elig);
    if (lane == 0) wcount[warp] = __popc(m);
    nan = __syncthreads_or(nan);
    const int f = *first;
    const bool go = active[b] && !nan && f < ef && od[f] < kBig && od[f] <= od[ef - 1];

    // take the first E eligible slots where the query goes on, by a ballot
    // prefix chunk by chunk of the block's width; every thread writes its
    // slot of the beam out
    int seen = 0;
    for (int base = 0;;) {
        const int t = base + tid;
        int r = seen + __popc(m & ((1u << lane) - 1u)), total = 0;
        for (int w = 0; w < warps; ++w) {
            const int c = wcount[w];
            r += w < warp ? c : 0;
            total += c;
        }
        const bool take = go && elig && r < E;
        if (t < ef) {
            out_d[b * ef + t] = od[t];
            out_ids[b * ef + t] = oid[t];
            out_exp[b * ef + t] = oexp[t] || take;
        }
        if (take) sel[b * E + r] = oid[t];
        seen += total;
        base += nt;
        if (base >= ef) break;
        __syncthreads();  // every warp has read this chunk's counts
        elig = base + tid < ef && !oexp[base + tid] && oid[base + tid] >= 0;
        m = __ballot_sync(0xffffffffu, elig);
        if (lane == 0) wcount[warp] = __popc(m);
        __syncthreads();
    }
    for (int r = (go ? min(seen, E) : 0) + tid; r < E; r += nt) sel[b * E + r] = -1;
    if (tid == 0) out_active[b] = go;
}

}  // namespace

// the dynamic shared memory of a block for a beam of ef and C candidates,
// or 0 where it passes what a block may use
extern "C" int hop_merge_shared_bytes(int ef, int C) {
    const long long bytes = shared_bytes(ef, C);
    return ef > 0 && C >= 0 && bytes <= kSmemMax ? (int)bytes : 0;
}

extern "C" int hop_merge(const void* beam_d, const void* beam_ids, const void* beam_exp,
                         const void* cand_d, const void* cand_ids, const void* active,
                         void* out_d, void* out_ids, void* out_exp, void* sel,
                         void* out_active, int B, int ef, int C, int E, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int smem = hop_merge_shared_bytes(ef, C);
    if (smem == 0 || E < 0) return (int)cudaErrorInvalidValue;
    // shared memory above the 48 KB default (a wide beam), set once per
    // device, at an eager call (never inside a graph capture)
    static bool sized[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (smem > kDefaultSmem && (dev >= 64 || !sized[dev])) {
        const cudaError_t err = cudaFuncSetAttribute(
            hop_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) sized[dev] = true;
    }
    const int width = ef > C ? ef : C;
    const int threads = width >= kMaxThreads ? kMaxThreads : (width + 31) / 32 * 32;
    hop_merge_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)beam_d, (const int*)beam_ids, (const bool*)beam_exp,
        (const float*)cand_d, (const int*)cand_ids, (const bool*)active, (float*)out_d,
        (int*)out_ids, (bool*)out_exp, (int*)sel, (bool*)out_active, ef, C, E);
    return (int)cudaGetLastError();
}

#!/usr/bin/env python3
"""The greedy-descent kernel (D1, csrc/descent.cu) on the CUDA card, at the
shape of chip_smoke.py's phase 4b: the 31,173 x 768 embedding-like corpus
(cosine, seed 42), its HNSW graph (M = 16), 1,024 and 32 of its rows as
queries walking every upper layer from the graph's entry over the bf16
shadow.

    python3 scripts/descent_ablate.py [stage ...] [--parent PATH] [--bulk PATH]
                                      [--tree DIR]

Stages (walk and kernels by default):
  walk    the walk of the plain version (greedy_descent_plain): the steps a
          query takes (mean, p99, max; a step scores one neighbourhood), the
          steps per layer (the queries' sum and the batch loop's count), and
          a pointer chase: one warp following adj_upper, each hop one
          dependent load from L2 (ld.global.cg, after a warm-up pass over the
          same path), timed by CUDA events and clock64; the latency floor is
          the longest walk's steps times that round trip.
  kernels the kernel as it stands and the parent's (csrc/descent.cu of the
          commit before the redesign, at PATH: unpack it with `git archive
          <commit> hnsw_tpu_torch/csrc/descent.cu | tar -x -C <dir>`), each
          built by nvcc into hnsw_tpu_torch/_build/ablate/, timed parent,
          change, change, parent at B = 1,024 and B = 32: one call (CUDA
          events around the launch, host work included) and back to back
          (20 launches between two events), also for the f32 euclidean
          walk; then the variants of the design (VARIANTS below), each
          csrc/descent.cu with one piece changed: the ids after the argmin
          (`no_ahead`), two warps a query, fewer warp-steps a batch, more
          blocks an SM, and two timing-only cuts: `loads_only` walks the
          plain version's recorded path (the neighbourhood row each step
          moved to) issuing the step's loads and folding each row with one
          xor, with no products, reductions, distances or argmin; `clocks`
          adds up thread 0's clock64 cycles a step in each phase (issue,
          scoring, the barrier, the argmin, the decision). `bulk`, the
          other way of moving the rows (each warp's rows copied by
          cp.async.bulk into shared memory on an mbarrier), is built from
          the kernel of commit 028c060, which held both ways behind its
          constant kRows, at PATH (--bulk: `git archive 028c060
          hnsw_tpu_torch/csrc/descent.cu | tar -x -C _chipdev/bulk`).
  insert  phase 5's wave insert (a stateful HNSW Index of 30,149 rows grown
          by 1,024), timed with the package of DIR (--tree; this checkout's
          by default), so that two trees compare in one call.

Every kernel's endpoints are held against the plain version's (identical for
>= 0.999 of queries) before it is timed. Prints one JSON line per reading,
with the card's name and power limit on the first line. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, SEED = 31173, 768, 42
PARENT = "_chipdev/parent/hnsw_tpu_torch/csrc/descent.cu"
BULK = "_chipdev/bulk/hnsw_tpu_torch/csrc/descent.cu"
# the edit that builds that source's bulk-copy rows
BULK_EDIT = ("constexpr int kRows = 1;", "constexpr int kRows = 0;")

# one warp following adj_upper[layer]: hop i loads adj[layer, cur, i % M]
# (a row id of that layer, or -1, which restarts at `start`), all lanes the
# same address, through L2 only (ld.global.cg)
CHASE_CU = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void chase_kernel(const int* __restrict__ adj, int n_pad, int m, int layer,
                             int start, int hops, int* __restrict__ out,
                             long long* __restrict__ cycles) {
    const int* a = adj + (long long)layer * n_pad * m;
    int cur = start;
    const long long t0 = clock64();
    for (int i = 0; i < hops; ++i) {
        const int nxt = __ldcg(a + (long long)cur * m + (i % m));
        cur = nxt >= 0 ? nxt : start;
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) {
        out[0] = cur;
        cycles[0] = t1 - t0;
    }
}

extern "C" int chase(const void* adj, int n_pad, int m, int layer, int start, int hops,
                     void* out, void* cycles, void* stream) {
    chase_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int*)adj, n_pad, m, layer, start,
                                                     hops, (int*)out, (long long*)cycles);
    return (int)cudaGetLastError();
}
'''
CHASE_HOPS = 20000


def say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvcc(name: str, text: str):
    """Build `text` into _build/ablate/lib<name>.so; returns (Popen, path)."""
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    lib = out_dir / f"lib{name}.so"
    return subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def finish(proc, lib, name: str):
    from hnsw_tpu_torch.ops import _cuda
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    return ctypes.CDLL(str(lib)), _cuda.kernel_resources(log)


def operands(torch):
    """Phase 4b's walk: the graph, the bf16 shadow, 1,024 queries from the
    graph's entry with their starting distances."""
    from hnsw_tpu_torch.io.datagen import generate_vectors
    from hnsw_tpu_torch.models import build_hnsw_index
    from hnsw_tpu_torch.ops.distance import shadow_score
    from hnsw_tpu_torch.types import Corpus

    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    corpus = Corpus.from_array(data, metric="cosine")
    g = build_hnsw_index(corpus, M=16).graph
    q = corpus.pad_queries(data[:1024])
    vectors = corpus.vectors.to(torch.bfloat16)
    cur = torch.full((q.shape[0],), g.entry, dtype=torch.int32,
                     device=q.device)
    d0 = shadow_score(q, cur[:, None].long(), vectors, corpus.sq_norms,
                      "cosine", (cur >= 0)[:, None])[:, 0].contiguous()
    return dict(q=q, q_sq=(q * q).sum(-1), cur=cur, d0=d0,
                upper=g.adj_upper, vectors=vectors, v_sq=corpus.sq_norms,
                f32_vectors=corpus.vectors, entry=int(g.entry))


def walk_steps(torch, x, b, metric="cosine"):
    """The plain walk of the first b queries, counted per query and layer:
    the batch loop of ops/descent.py:_descend_layer with a step count for
    each query, and its path: path[q, s] the neighbourhood row step s of
    query q moved to, or -1 where it dropped a layer (or ended). Held
    against greedy_descent_plain's endpoints and visits."""
    from hnsw_tpu_torch.ops import descent
    from hnsw_tpu_torch.ops.distance import shadow_score

    q, q_sq = x["q"][:b], x["q_sq"][:b].reshape(-1, 1)
    cur, cd = x["cur"][:b], x["d0"][:b]
    upper = x["upper"]
    per_layer, moves = [], []
    at = torch.zeros_like(cur)
    for l in range(upper.shape[0] - 1, -1, -1):
        adj_l = upper[l]
        improving = torch.ones_like(cur, dtype=torch.bool)
        steps = torch.zeros_like(cur)
        while bool(improving.any()):
            steps += improving.int()
            nb = adj_l[cur]
            valid = (nb >= 0) & improving[:, None]
            d = shadow_score(q, torch.clamp(nb, min=0), x["vectors"],
                             x["v_sq"], metric, valid, q_sq=q_sq)
            j = torch.argmin(d, dim=-1, keepdim=True)
            best_d = torch.gather(d, -1, j)[:, 0]
            best_id = torch.gather(nb, -1, j)[:, 0]
            better = (best_d < cd) & improving
            moves.append((at[improving].long(), improving,
                          torch.where(better, j[:, 0].int(), -1)[improving]))
            at = at + improving.int()
            cur = torch.where(better, best_id, cur)
            cd = torch.where(better, best_d, cd)
            improving = better
        per_layer.append((l, steps))
    path = torch.full((b, int(at.max())), -1, dtype=torch.int32,
                      device=cur.device)
    for pos, improving, j in moves:
        path[improving.nonzero()[:, 0], pos] = j
    visits = []
    pc, _ = descent.greedy_descent_plain(
        q, x["q_sq"][:b], x["cur"][:b], x["d0"][:b], upper, x["vectors"],
        x["v_sq"], metric, visits=visits)
    if not torch.equal(pc, cur):
        raise AssertionError("the counted walk ends elsewhere than the plain "
                             "version's")
    for l, steps in per_layer:
        got = sum(int(rows.numel()) for vl, _, rows in visits if vl == l)
        if got != int(steps.sum()):
            raise AssertionError(f"layer {l}: {int(steps.sum())} steps "
                                 f"counted, the plain version's visits {got}")
    return per_layer, visits, path.contiguous()


def chase_round_trip(torch, x):
    """Microseconds of one dependent L2 load, from one warp chasing
    adj_upper's lowest upper layer (the largest) from the graph's entry."""
    from hnsw_tpu_torch.ops import _cuda
    proc, lib = nvcc("chase", CHASE_CU)
    cdll, _ = finish(proc, lib, "chase")
    fn = cdll.chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    upper = x["upper"]
    _, n_pad, m = upper.shape
    out = torch.zeros(1, dtype=torch.int32, device=upper.device)
    cycles = torch.zeros(1, dtype=torch.int64, device=upper.device)
    stream = _cuda.stream_ptr(upper.device)

    def run():
        _cuda.check(fn(upper.data_ptr(), n_pad, m, 0, x["entry"], CHASE_HOPS,
                       out.data_ptr(), cycles.data_ptr(), stream), "chase")

    run()                       # the warm-up pass puts the path in L2
    torch.cuda.synchronize()
    times, cyc = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / CHASE_HOPS)
        cyc.append(int(cycles[0]) / CHASE_HOPS)
    return statistics.median(times), statistics.median(cyc)


def stage_walk(torch, x):
    for b in (1024, 32):
        per_layer, visits, _ = walk_steps(torch, x, b)
        total = sum(steps for _, steps in per_layer).float()
        srt = torch.sort(total).values
        say(stage="walk", B=b, layers=x["upper"].shape[0],
            M=x["upper"].shape[2], steps_mean=float(total.mean()),
            steps_p99=float(srt[min(b - 1, int(0.99 * b))]),
            steps_max=int(total.max()), batch_steps=len(visits),
            steps_per_layer={l: round(float(s.float().mean()), 4)
                             for l, s in per_layer},
            max_steps_per_layer={l: int(s.max()) for l, s in per_layer})
        if b == 1024:
            longest = int(total.max())
    us, cycles = chase_round_trip(torch, x)
    say(stage="chase", hops=CHASE_HOPS, round_trip_us=us,
        round_trip_cycles=cycles, longest_walk_steps=longest,
        latency_floor_ms=longest * us / 1e3)


# variants of csrc/descent.cu: (old, new) edits, each found once
WARPS = "constexpr int kWarps = 4;"
STEPS = "    return nc == 6 ? (bytes == 2 ? 1 : 2) : 4;"
BOUNDS = "__launch_bounds__(kThreads, kMinBlocks)"
AHEAD = "    for (p.ahead = 1; p.ahead >= 0; --p.ahead) {"
KBIG = "constexpr float kBig = 1e30f;             // ops/distance.py BIG\n"
P_DECL = "    int p = 0;\n"
TOP = "        int* next = ids_buf + (p ^ 1) * slots * M;\n"
ROWS = "        // the rows of the warp's warp-steps, G at a time\n"
BARRIER = "        cp_async_wait_all();\n        __syncthreads();\n        // every warp takes"
ARGMIN = "        for (int j = lane; j < M; j += 32)\n            if (key_p[j] < key"
MOVE = "        const bool move = rmin < (uint32_t)M && best_d < cd;   // strictly nearer\n"
TAKE = "            cur = kid_p[rmin];\n"
NEXT = "            ids = next + (move ? (int)rmin : down) * M;\n"
OUT = "    if (threadIdx.x == 0) {\n        cur_out[b] = cur;\n"
DOT = "acc[g] = dot_chunk<T>(q[i], raw[g][i], acc[g]);"
HALVING = "for (int half = G / 2, o = plan.lanes >> 1; half >= 1; half >>= 1, o >>= 1) {"
ADDING = "for (int o = plan.lanes / (2 * G); o > 0; o >>= 1)"
KEY = "order_key(id[0] >= 0 ? distance<METRIC>(acc[0], qsq, csq[0]) : kBig)"
LAST_ENTRY = 'extern "C" int greedy_descent_f32('


def _entry(code: str) -> str:
    return code + "\n" + LAST_ENTRY


VARIANTS = {
    "as_is": [],
    # design point 1 off: the next step's ids fetched after the argmin
    "no_ahead": [(AHEAD, "    for (p.ahead = 0; p.ahead >= 0; --p.ahead) {")],
    "warps_2": [(WARPS, "constexpr int kWarps = 2;")],
    # warp-steps a batch, and registers (blocks an SM)
    "steps_2": [(STEPS, STEPS.replace(": 4;", ": 2;"))],
    "blocks_6": [(BOUNDS, "__launch_bounds__(kThreads, NC == 6 ? 4 : 6)")],
    "blocks_8": [(BOUNDS, "__launch_bounds__(kThreads, NC == 6 ? 4 : 8)"),
                 (STEPS, STEPS.replace(": 4;", ": 2;"))],
    # timing only: the recorded path's loads (rows, norms, ids), each row
    # folded with one xor, no products, reductions, distances or argmin
    "loads_only": [
        (KBIG, KBIG + "__device__ const int* g_path;\n__device__ int g_stride;\n"),
        (P_DECL, "    int p = 0, step = 0;\n"),
        (TOP, TOP + "        const int rec = g_path[(long long)b * g_stride + step++];\n"
         "        const int rec_id = rec >= 0 ? ids[rec] : -1;\n"),
        (DOT, "acc[g] = __uint_as_float(__float_as_uint(acc[g]) ^ raw[g][i].x ^ raw[g][i].w);"),
        (HALVING, HALVING.replace("half >= 1;", "false;")),
        (ADDING, ADDING.replace("o > 0;", "false;")),
        (KEY, "__float_as_uint(acc[0]) ^ __float_as_uint(csq[0])"),
        (ARGMIN, ARGMIN.replace("j < M", "j < 0")),
        (MOVE, "        const bool move = rec >= 0;\n"),
        (TAKE, "            cur = rec_id;\n"),
        (NEXT, NEXT.replace("(int)rmin", "rec")),
        (LAST_ENTRY, _entry(
            'extern "C" int descent_set_path(const void* path, int stride) {\n'
            "    cudaMemcpyToSymbol(g_path, &path, sizeof(path));\n"
            "    cudaMemcpyToSymbol(g_stride, &stride, sizeof(int));\n"
            "    return (int)cudaGetLastError();\n}\n")),
    ],
    # timing only: thread 0's clock64 cycles a step in each phase
    "clocks": [
        (KBIG, KBIG + "__device__ long long* g_clocks;\n"
         "#define TICK(k) { const long long t_ = clock64(); "
         "if (threadIdx.x == 0) ck[k] += t_ - tk; tk = t_; }\n"),
        (P_DECL, P_DECL + "    __shared__ long long ck[5];\n"
         "    if (threadIdx.x < 5) ck[threadIdx.x] = 0;\n"
         "    int nsteps = 0;\n    long long tk = clock64();\n"),
        (TOP, "        TICK(4);\n        ++nsteps;\n" + TOP),
        (ROWS, "        TICK(0);\n" + ROWS),
        (BARRIER, "        TICK(1);\n" + BARRIER.replace(
            "__syncthreads();\n", "__syncthreads();\n        TICK(2);\n")),
        (MOVE, "        TICK(3);\n" + MOVE),
        (OUT, "    if (threadIdx.x == 0) {\n"
         "        for (int k = 0; k < 5; ++k) g_clocks[b * 8 + k] = ck[k];\n"
         "        g_clocks[b * 8 + 7] = nsteps;\n    }\n" + OUT),
        (LAST_ENTRY, _entry(
            'extern "C" int descent_set_clocks(void* clocks) {\n'
            "    cudaMemcpyToSymbol(g_clocks, &clocks, sizeof(clocks));\n"
            "    return (int)cudaGetLastError();\n}\n")),
    ],
}
PHASES = ("issue", "score", "barrier", "argmin", "decide")
TIMING_ONLY = ("loads_only", "clocks")
# the instantiation of the main path: bf16, cosine, three chunks a lane
MAIN_PIECE = "I13__nv_bfloat16Li0ELi3E"


def edited(text: str, edits, where: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the piece to replace is not in {where} "
                               f"once: {old!r}")
        text = text.replace(old, new)
    return text


def build_kernels(names, parent, bulk):
    """{name: (C entry points by dtype, ptxas of the main instantiation)}
    for the parent's source, the bulk-copy kernel and the variants, built
    in parallel."""
    from hnsw_tpu_torch.ops import _cuda
    sources = {"parent": open(parent).read()} if parent else {}
    if bulk:
        sources["bulk"] = edited(open(bulk).read(), [BULK_EDIT], bulk)
    text = (_cuda.CSRC / "descent.cu").read_text()
    sources.update({n: edited(text, VARIANTS[n], "descent.cu")
                    for n in names})
    procs = {n: nvcc(f"descent_{n}", text) for n, text in sources.items()}
    libs = {}
    for n, (proc, lib) in procs.items():
        cdll, res = finish(proc, lib, n)
        fns = {}
        for dtype, entry in (("bf16", "greedy_descent_bf16"),
                             ("f32", "greedy_descent_f32")):
            fn = getattr(cdll, entry)
            fn.argtypes = list(_cuda.SIGNATURES["descent.cu"][entry])
            fn.restype = ctypes.c_int
            fns[dtype] = fn
        if n == "loads_only":
            fns["set_path"] = cdll.descent_set_path
            fns["set_path"].argtypes = [ctypes.c_void_p, ctypes.c_int]
            fns["set_path"].restype = ctypes.c_int
        if n == "clocks":
            fns["set_clocks"] = cdll.descent_set_clocks
            fns["set_clocks"].argtypes = [ctypes.c_void_p]
            fns["set_clocks"].restype = ctypes.c_int
        main = [v for k, v in res.items() if MAIN_PIECE in k]
        libs[n] = (fns, dict(registers=main[0][0], spill_bytes=main[0][1])
                   if main else {})
    return libs


def time_launch(torch, call, reps: int = 20):
    """(one call, back to back) in ms: the median of `reps` single launches
    between CUDA events (the launch's host work included), and of 10 runs of
    20 launches between two events, over 20."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    one, burst = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        one.append(start.elapsed_time(end))
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        burst.append(start.elapsed_time(end) / 20)
    return statistics.median(one), statistics.median(burst)


def configs(torch, x):
    """(label, metric, operands) of the readings: phase 4b's bf16 cosine
    walk at B = 1,024 and B = 32, and its f32 euclidean walk at 1,024."""
    from hnsw_tpu_torch.ops.distance import shadow_score
    ops = {k: x[k] for k in ("q", "q_sq", "cur", "d0", "upper", "vectors",
                             "v_sq")}
    out = [("bf16 cosine B=1024", "cosine", ops),
           ("bf16 cosine B=32", "cosine",
            {k: (v[:32].contiguous() if k in ("q", "q_sq", "cur", "d0")
                 else v) for k, v in ops.items()})]
    vf = x["f32"]
    d0 = shadow_score(x["q"], x["cur"][:, None].long(), vf, x["v_sq"],
                      "euclidean", (x["cur"] >= 0)[:, None])[:, 0].contiguous()
    out.append(("f32 euclidean B=1024", "euclidean",
                dict(ops, vectors=vf, d0=d0)))
    return out


def reading(torch, name, fns, label, metric, o, want, timing_only=False):
    from hnsw_tpu_torch.ops import _cuda
    from hnsw_tpu_torch.ops.descent import METRIC_CODES
    from hnsw_tpu_torch.types import Metric
    b, d = o["q"].shape
    layers, n_pad, m = o["upper"].shape
    fn = fns["bf16" if o["vectors"].dtype == torch.bfloat16 else "f32"]
    out_cur = torch.empty_like(o["cur"])
    out_d = torch.empty_like(o["d0"])
    stream = _cuda.stream_ptr(o["q"].device)
    code = METRIC_CODES[Metric.coerce(metric)]

    def call():
        _cuda.check(fn(o["q"].data_ptr(), o["q_sq"].data_ptr(),
                       o["cur"].data_ptr(), o["d0"].data_ptr(),
                       o["upper"].data_ptr(), o["vectors"].data_ptr(),
                       o["v_sq"].data_ptr(), out_cur.data_ptr(),
                       out_d.data_ptr(), b, layers, n_pad, m, d, code,
                       stream), name)

    call()
    torch.cuda.synchronize()
    pc, pd = want
    same = out_cur == pc
    agree = float(same.float().mean())
    err = float((out_d - pd)[same].abs().max()) if bool(same.any()) else None
    if agree < 0.999:
        raise AssertionError(f"{name} {label}: endpoints agree {agree}")
    one, b2b = time_launch(torch, call)
    row = dict(stage="kernels", kernel=name, reading=label, one_call_ms=one,
               back_to_back_ms=b2b, endpoints_identical=agree)
    if not timing_only:
        row["max_abs_err"] = err
    return row


def stage_kernels(torch, x, parent, bulk):
    from hnsw_tpu_torch.ops import descent

    libs = build_kernels(list(VARIANTS),
                         parent if os.path.exists(parent) else None,
                         bulk if os.path.exists(bulk) else None)
    names = [n for n in libs if n != "parent"]
    x["f32"] = x.pop("f32_vectors")
    cfgs = configs(torch, x)
    wants = {label: descent.greedy_descent_plain(
        o["q"], o["q_sq"], o["cur"], o["d0"], o["upper"], o["vectors"],
        o["v_sq"], metric) for label, metric, o in cfgs}
    m, d = x["upper"].shape[2], x["q"].shape[1]
    say(stage="kernels", shared_bytes=descent.shared_bytes(m, d, 2),
        shared_bytes_f32=descent.shared_bytes(m, d, 4),
        ptxas={n: res for n, (_, res) in libs.items()})
    # parent, change, change, parent at each reading
    for label, metric, o in cfgs:
        order = (["parent", "as_is", "as_is", "parent"] if "parent" in libs
                 else ["as_is", "as_is"])
        for name in order:
            say(**reading(torch, name, libs[name][0], label, metric, o,
                          wants[label]))
    # the variants at the bf16 readings, the kernel as it stands around them
    _, _, path = walk_steps(torch, x, 1024)
    libs["loads_only"][0]["set_path"](path.data_ptr(), path.shape[1])
    torch.cuda.synchronize()
    for label, metric, o in cfgs[:2]:
        for name in names + ["as_is"]:
            b = o["q"].shape[0]
            timing_only = name in TIMING_ONLY
            clocked = name == "clocks"
            if clocked:
                clocks = torch.zeros(b * 8, dtype=torch.int64,
                                     device=o["q"].device)
                libs[name][0]["set_clocks"](clocks.data_ptr())
                torch.cuda.synchronize()
            row = reading(torch, name, libs[name][0], label, metric, o,
                          wants[label], timing_only=timing_only)
            if clocked:
                # thread 0's cycles a step in each phase, over all blocks
                # and in the block of the longest walk (the last launch's)
                ck = clocks.view(b, 8).cpu()
                steps = ck[:, 7]
                slow = int(steps.argmax())
                row.update(
                    cycles_per_step={ph: float(ck[:, k].sum() / steps.sum())
                                     for k, ph in enumerate(PHASES)},
                    longest_walk=int(steps[slow]),
                    longest_walk_cycles={ph: int(ck[slow, k])
                                         for k, ph in enumerate(PHASES)})
            say(**row)


def stage_insert(torch):
    """Phase 5's wave insert (chip_smoke.py, api_path (d)) with the package
    of the tree on sys.path: a stateful HNSW Index over the first 30,149
    rows, then one add_batch of the last 1,024; seconds of each flush."""
    import time

    import hnsw_tpu_torch as ht
    from hnsw_tpu_torch.io.datagen import generate_vectors

    data = generate_vectors(N, DIM, distribution="embedding",
                            num_clusters=64, seed=SEED)
    n0 = len(data) - 1024
    ids = [f"doc{i}" for i in range(len(data))]
    ix = ht.Index(dimensions=DIM, index_type="hnsw", M=16)
    for i in range(n0):
        ix.add(ids[i], data[i], metadata={"row": i})
    t0 = time.perf_counter()
    assert ix.size == n0
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix.add_batch([(ids[i], data[i], {"row": i}) for i in range(n0, len(data))])
    t0 = time.perf_counter()
    assert ix.size == len(data)
    torch.cuda.synchronize()
    say(stage="insert", tree=os.path.dirname(ht.__file__),
        build_seconds=build_s, insert_seconds=time.perf_counter() - t0)


def main() -> int:
    args = sys.argv[1:]
    paths = {"--parent": PARENT, "--bulk": BULK}
    for flag in paths:
        if flag in args:
            i = args.index(flag)
            paths[flag] = args[i + 1]
            del args[i:i + 2]
    if "--tree" in args:
        # the package of another checkout (the insert stage)
        i = args.index("--tree")
        sys.path.insert(0, os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    import torch
    if not torch.cuda.is_available():
        print("descent_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401  (sets TF32 off)

    stages = args or ["walk", "kernels"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    x = None
    for stage in stages:
        if stage in ("walk", "kernels") and x is None:
            x = operands(torch)
        if stage == "walk":
            stage_walk(torch, x)
        elif stage == "kernels":
            stage_kernels(torch, x, paths["--parent"], paths["--bulk"])
        elif stage == "insert":
            stage_insert(torch)
        else:
            print(f"descent_ablate: no stage {stage}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

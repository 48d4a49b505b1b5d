#!/usr/bin/env python3
"""Timed ablations of the int8 hop kernel (hop_score_int8, csrc/hop.cu) on
the CUDA card, at glove's hop (hnsw_tpu_torch/bench/kernels.py, HOP_SHAPES
"c": B = 1024 queries, E = 4 selected blocks of M0 = 32 rows, D = 128, a
pack of 500,000 blocks; the narrow plan, eight lanes a row) and at
chip_smoke.py's main-path hop ("a": the same at D = 768 over 31,176
blocks; all 32 lanes on a row, three 8-byte units a lane).

    python3 scripts/hop_int8_ablate.py [variant ...]

Each variant is csrc/hop.cu with one piece of its design changed, built by
nvcc into hnsw_tpu_torch/_build/ablate/ (all at once) and called through its
C entry: the kernel as it stands; warp-steps a task (kI8Steps) 2 or 8
instead of 4; the codes loaded through L1 (__ldg) instead of with
L1::no_allocate; 16-byte units at every width (at D = 768 two a lane, the second on half
the lanes, in place of three 8-byte units); one warp a query (parts 1) and
one warp a task (parts = tasks, whatever the card holds at once); the
launch bounds asking for 8 blocks an SM (at most 64 registers); and each
byte converted by I2F ((float)(int8_t)byte) instead of the byte_perm
conversion. Prints one JSON line per variant and
shape: ptxas registers and spill bytes of the instantiation the shape runs,
the largest difference from hop_score_int8_plain, the median of 30
CUDA-event timings of one call, and one call's device time as a node of a
CUDA graph of eight calls on eight (queries, sel) draws (graph_ms: no host
work between calls, the working set past the 50 MB L2, as the search's
bodies pay), beside the byte bound of those draws. The package's own
wrapper and the bf16 kernel (hop_score, on a bf16 pack of the same shape)
are timed beside them.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 42
SHAPES = ("c", "a")
# the ptxas pieces of each shape's instantiation, <lanes a row, units a lane,
# bytes a unit>, the first one built (units_16 runs the second at (a))
INSTANTIATION = {"c": ("15hop_int8_kernelILi8ELi1ELi16EE",),
                 "a": ("15hop_int8_kernelILi32ELi3ELi8EE",
                       "15hop_int8_kernelILi32ELi2ELi16EE")}

STEPS = "constexpr int kI8Steps = 4;"
PARTS = "plan.parts = fit < 1 ? 1 : fit < plan.tasks ? fit : plan.tasks;"
UNIT = "p.unit = fill(D / 8) > fill(D / 16) ? 8 : 16;"
BOUNDS = "__launch_bounds__(kI8Threads)\nhop_int8_kernel("
LOAD16 = ("asm volatile(\"ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, "
          "%3}, [%4];\"\n"
          "                     : \"=r\"(w[0]), \"=r\"(w[1]), \"=r\"(w[2]), "
          "\"=r\"(w[3])\n"
          "                     : \"l\"(p));")
LDG16 = ("const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));\n"
         "        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;")
LOAD8 = ("asm volatile(\"ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\"\n"
         "                     : \"=r\"(w[0]), \"=r\"(w[1])\n"
         "                     : \"l\"(p));")
LDG8 = ("const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));\n"
        "        w[0] = v.x; w[1] = v.y;")
CONVERT = ("__fsub_rn(\n"
           "                                __int_as_float(__byte_perm(word, "
           "0x4B000000u, 0x7650 + j)),\n"
           "                                8388736.f)")
I2F = "(float)(int8_t)((word ^ 0x80808080u) >> (8 * j))"
VARIANTS = {
    "as_is": [],
    "steps_2": [(STEPS, STEPS.replace("4", "2"))],
    "steps_8": [(STEPS, STEPS.replace("4", "8"))],
    "l1_allocate": [(LOAD16, LDG16), (LOAD8, LDG8)],
    "units_16": [(UNIT, "p.unit = 16;")],
    "parts_1": [(PARTS, "plan.parts = 1;")],
    "parts_tasks": [(PARTS, "plan.parts = plan.tasks;")],
    "min_blocks_8": [(BOUNDS, BOUNDS.replace("(kI8Threads)",
                                             "(kI8Threads, 8)"))],
    "i2f": [(CONVERT, I2F)],
}


def build(variants: dict) -> dict:
    from hnsw_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "hop.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the piece to replace is not in "
                                   "hop.cu once")
            text = text.replace(old, new)
        cu = out_dir / f"hop_int8_{name}.cu"
        # the headers hop.cu includes are the toolkit's own
        cu.write_text(text)
        lib = out_dir / f"libhop_int8_{name}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        res = _cuda.kernel_resources(log)
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.hop_score_int8
        fn.argtypes = list(_cuda.SIGNATURES["hop.cu"]["hop_score_int8"])
        fn.restype = ctypes.c_int
        libs[name] = (fn, {key: next((v for piece in pieces
                                      for k, v in res.items() if piece in k),
                                     (None, None))
                           for key, pieces in INSTANTIATION.items()})
    return libs


def graph_ms(torch, calls, reps: int = 20) -> float:
    """One call's device time as a node of a CUDA graph of the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("hop_int8_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    import hnsw_tpu_torch  # noqa: F401
    from hnsw_tpu_torch.bench.kernels import (HBM_BYTES_S, HOP_ROTATIONS,
                                              HOP_SHAPES, hop_bytes,
                                              hop_operands, median_ms)
    from hnsw_tpu_torch.ops import _cuda, hop

    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(VARIANTS)}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build({n: VARIANTS[n] for n in names})
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for key in SHAPES:
        shape = HOP_SHAPES[key]
        x = hop_operands(SEED, shape=shape, rotations=HOP_ROTATIONS)
        codes, draws = x["codes"], x["draws"]
        b, e, m0, d, n_pad = (shape[k] for k in ("b", "e", "m0", "d",
                                                 "n_pad"))
        nbytes = statistics.mean(hop_bytes(codes, q, s, 1) for q, s in draws)
        queries, sel = draws[0]
        want = hop.hop_score_int8_plain(codes, queries, sel)
        tol = 1e-4 * float(want.abs().max())
        outs = [torch.empty((b, e * m0), dtype=torch.float32, device=dev)
                for _ in draws]
        for name, (fn, res) in libs.items():

            def launch(q, s, out):
                return lambda: _cuda.check(
                    fn(codes.data_ptr(), q.data_ptr(), s.data_ptr(),
                       out.data_ptr(), b, e, m0, d, n_pad,
                       _cuda.stream_ptr(dev)), name)
            calls = [launch(q, s, out) for (q, s), out in zip(draws, outs)]
            calls[0]()
            torch.cuda.synchronize()
            err = float((outs[0] - want).abs().max())
            regs, spill = res[key]
            print(json.dumps({
                "variant": name, "shape": key, "d": d, "registers": regs,
                "spill_bytes": spill, "max_abs_err": err, "tol": tol,
                "ms": median_ms(calls[0], reps=30),
                "graph_ms": graph_ms(torch, calls),
                "bound_ms": nbytes / HBM_BYTES_S * 1e3}), flush=True)
            if err > tol:
                print(f"{name} disagrees with the plain version at ({key})",
                      file=sys.stderr)
                return 1
        pack = x["pack"]
        for name, fn, tensor in (
                ("hop_score_int8 (the package's wrapper)", hop.hop_score_int8,
                 codes),
                ("hop_score (bf16 pack)", hop.hop_score, pack)):
            calls = [(lambda q=q, s=s: fn(tensor, q, s)) for q, s in draws]
            print(json.dumps({"variant": name, "shape": key, "d": d,
                              "ms": median_ms(calls[0], reps=30),
                              "graph_ms": graph_ms(torch, calls)}),
                  flush=True)
        del x, codes, draws, pack, outs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

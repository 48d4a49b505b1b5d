"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 -m benchmark.run --workload bible31k.bulk --seed 7 --seconds 30 --trace 0

Prints the result as the last line of standard output (one JSON object) and
each compared number beside its limit as the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card or with fewer cards
than the cell asks for, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.spec import ROOT, load_cell  # noqa: E402

# the top-level modules that must not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_tpu")
# build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell there builds (the program's own nvcc libraries go
# to hnsw_tpu_torch/_build/, also inside the checkout)
CACHE = ROOT / ".bench_cache"


def _pin_caches():
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def forbidden_modules():
    """Forbidden top-level names among the loaded modules, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_caches()
    spec = load_cell(args.workload)
    import torch

    import hnsw_tpu_torch  # noqa: F401  (the system under test must be here)
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: cell {args.workload} needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)

    from benchmark.cell import run_cell
    result = run_cell(spec, seed=args.seed, seconds=args.seconds,
                      trace_on=bool(args.trace), device="cuda",
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

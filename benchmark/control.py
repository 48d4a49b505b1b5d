"""The readings that set the limits of ``max_dist_gap``: the program's, and
the control's, on many seeds in one process, on the card:

    python3 -m benchmark.control --workload bible31k.bulk --seeds 11,12,13 --seconds 3

For each seed, one run of the cell (a short window, as the benchmark runs
it) gives the program's compared numbers; then the control, the plain
reference with TF32 products (``reference.control_answers``) put in the
program's place, answers the same requests and the same check judges it.
Prints one JSON line a seed and a last line with the program's largest gap
(the lower reading), the control's smallest (the upper reading), and whether
the configuration's limit sits between them. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import reference
from benchmark.cell import Client, run_cell
from benchmark.datagen import make_data
from benchmark.spec import load_cell


def control_check(spec: dict, seed: int, requests: int, device) -> dict:
    """The check's numbers for the control answering `requests` batches of
    the cell, as a window of that many requests would send them."""
    cfg = spec["config"]
    corpus, pool = make_data(cfg, seed)
    rows, dists = reference.control_answers(corpus, pool, cfg["k"],
                                            cfg["metric"], device)
    client = Client(pool, spec["traffic"]["batch"])
    qidx = np.concatenate([client.rows(j) for j in range(requests)])
    verdict = reference.judge(corpus, pool, qidx, rows[qidx], dists[qidx],
                              k=cfg["k"], metric=cfg["metric"], device=device)
    verdict.pop("invalid")
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    limit = spec["config"]["correct"]["max_dist_gap"]
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(spec, seed=seed, seconds=args.seconds, trace_on=False)
        ctl = control_check(spec, seed, res["attempted"], "cuda")
        torch.cuda.empty_cache()
        prog = {k: v["value"] for k, v in res["checks"].items()}
        program.append(prog["max_dist_gap"])
        control.append(ctl["max_dist_gap"])
        print(json.dumps(dict(seed=seed, correct=res["correct"],
                              attempted=res["attempted"], program=prog,
                              control=ctl)), flush=True)
    print(json.dumps(dict(
        workload=args.workload, seeds=len(program),
        program_max_gap=max(program), control_min_gap=min(control),
        limit=limit, control_fails=min(control) > limit,
        program_passes=max(program) <= limit)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The nytimes290k.bulk cell's own path on the CPU, at a small size: a
traced dry run whose layer 0 takes the clustered builder (LARGE_N lowered
below the rows, the rows past one cell of cluster_size 4,096 so that the
NN-descent round runs) reads each build.large.* stage, and the levels of the
configuration's 290,000 rows put layer 0 past LARGE_N and layer 1 below it.
Imports no JAX: this folder also runs on the card's machine."""

import math

import pytest
import torch

from benchmark import cell, program_trace
from benchmark.cell import run_cell
from benchmark.spec import load_cell
from hnsw_tpu_torch.models.hnsw import build_large
from hnsw_tpu_torch.models.hnsw.graph import assign_levels

CELL = "nytimes290k.bulk"
STAGES = ["build.large.kmeans_s", "build.large.cells_s",
          "build.large.symmetrize_s", "build.large.refine_s"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_traced_dry_run_reads_the_clustered_stages(monkeypatch):
    spec = load_cell(CELL)
    cfg = spec["config"]
    assert {m["name"] for m in spec["per_layer"]} == set(STAGES)
    # 4,600 rows x 256: layer 0 (4,600) past LARGE_N and past one cell,
    # layer 1 (about 2,300) below LARGE_N, as at 290,000 rows; one timed
    # build keeps the run short
    monkeypatch.setattr(build_large, "LARGE_N", 4000)
    monkeypatch.setattr(cell, "BUILDS", 1)
    monkeypatch.setattr(program_trace, "BUILDS", 1)
    spec["config"] = dict(cfg, rows=4600, queries=160)
    spec["traffic"] = dict(spec["traffic"], batch=32)
    read = []
    real_read = program_trace._read
    monkeypatch.setattr(program_trace, "_read",
                        lambda ctx: read.append(real_read(ctx)) or read[-1])
    res = run_cell(spec, seed=2**31 + 19, seconds=0.5, trace_on=True,
                   device="cpu")
    got = {name: res["metrics"][name]["value"] for name in STAGES}
    assert all(v > 0 for v in got.values()), got
    assert sum(got.values()) <= read[0].mean("builds", "layers")
    checks = res["checks"]
    assert checks["invalid_answers"]["value"] == 0
    assert checks["max_dist_gap"]["value"] <= \
        cfg["correct"]["max_dist_gap"]
    assert checks["recall_at_10"]["value"] >= \
        cfg["correct"]["recall_at_10"]
    assert res["correct"] is True


def test_layer0_takes_the_clustered_builder_and_layer1_the_exact():
    """The levels build_graph draws for the configuration's rows (ml 1/ln 2,
    seed 42, as build_hnsw_index calls it) with LARGE_N as shipped."""
    n = load_cell(CELL)["config"]["rows"]
    levels = assign_levels(n, 1.0 / math.log(2.0), 42,
                           max_cap=max(int(math.log2(max(n, 2))), 1))
    assert n > build_large.LARGE_N
    assert 0 < int((levels >= 1).sum()) <= build_large.LARGE_N

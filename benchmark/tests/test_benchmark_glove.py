"""The glove1.2m.bulk cell's own path on the CPU, at a small size: a traced
dry run whose layers 0-2 take the clustered builder (LARGE_N lowered below
them, layer 0 past one cell of cluster_size 4,096 so that the NN-descent
round runs) and whose search takes the int8 neighbour pack (the pack cap
lowered between the int8 and the bf16 pack's bytes) reads the dequant phase
and the clustered layers' spans; the levels of the configuration's
800,000 rows put layers 0-2 past LARGE_N and layer 3 below it, and the
bf16 pack at D_pad 128 past the cap, the int8 pack under it. Imports no JAX:
this folder also runs on the card's machine."""

import math

import pytest
import torch

from benchmark import cell, program_trace
from benchmark.cell import run_cell
from benchmark.spec import load_cell
from hnsw_tpu_torch.models.hnsw import build_large
from hnsw_tpu_torch.models.hnsw.graph import assign_levels
from hnsw_tpu_torch.models.hnsw.shadow import PACK_BYTES_CAP, HopShadow
from hnsw_tpu_torch.types import LANE, SUBLANE, round_up

CELL = "glove1.2m.bulk"
METRICS = ["hop_score_int8_roofline", "search.phase.dequant_ms",
           "build.clustered_l0_s", "build.clustered_upper_s"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _levels(n):
    """Rows of each layer, as build_graph draws them (ml 1/ln 2, seed 42)."""
    lv = assign_levels(n, 1.0 / math.log(2.0), 42,
                       max_cap=max(int(math.log2(max(n, 2))), 1))
    return [int((lv >= l).sum()) for l in range(int(lv.max()) + 1)]


def _pack_bytes(rows, m0, dim):
    """(bf16, int8) pack bytes of HopShadow.prepare at the padded width."""
    slots = round_up(rows, SUBLANE) * m0
    d = round_up(dim, LANE)
    return slots * (2 * d + 4), slots * (d + 8)


def test_traced_dry_run_reads_the_int8_route_and_clustered_layers(
        monkeypatch):
    spec = load_cell(CELL)
    cfg = spec["config"]
    assert {m["name"] for m in spec["per_layer"]} == set(METRICS)
    # 4,600 rows x 100: layers 0-2 (4,600, 2,322, 1,183) past LARGE_N, layer
    # 0 past one cell, layer 3 (581) below it, as at 800,000 rows; one
    # timed build keeps the run short
    rows = 4600
    monkeypatch.setattr(build_large, "LARGE_N", 1000)
    monkeypatch.setattr(cell, "BUILDS", 1)
    monkeypatch.setattr(program_trace, "BUILDS", 1)
    bf16, int8 = _pack_bytes(rows, cfg["index"]["max_M0"], cfg["dim"])
    monkeypatch.setitem(HopShadow.prepare.__kwdefaults__, "cap",
                        (bf16 + int8) // 2)
    spec["config"] = dict(cfg, rows=rows, queries=160)
    spec["traffic"] = dict(spec["traffic"], batch=32)
    read = []
    real_read = program_trace._read
    monkeypatch.setattr(program_trace, "_read",
                        lambda ctx: read.append(real_read(ctx)) or read[-1])
    res = run_cell(spec, seed=2**31 + 23, seconds=0.5, trace_on=True,
                   device="cpu")
    got = {name: res["metrics"].get(name, {}).get("value")
           for name in METRICS}
    assert got["hop_score_int8_roofline"] is None      # no CUDA launch
    for name in METRICS[1:]:
        assert got[name] is not None and got[name] > 0, got
    assert read[0].batches > 0 and read[0].phase_ms["dequant"] > 0
    assert got["build.clustered_l0_s"] + got["build.clustered_upper_s"] <= \
        read[0].mean("builds", "layers")
    (build,) = read[0].builds
    assert sorted(k for k in build if k.startswith("clustered_l")) == [
        "clustered_l0", "clustered_l1", "clustered_l2"]
    checks = res["checks"]
    assert checks["invalid_answers"]["value"] == 0
    assert checks["max_dist_gap"]["value"] <= \
        cfg["correct"]["max_dist_gap"]
    assert checks["recall_at_10"]["value"] >= \
        cfg["correct"]["recall_at_10"]
    assert res["correct"] is True


def test_three_clustered_layers_and_the_int8_pack_at_full_size():
    """The configuration's rows as build_graph draws their levels, with
    LARGE_N and the pack cap as shipped: layers 0-2 take the clustered
    builder and layer 3 the exact one; the bf16 pack passes the cap and the
    int8 pack fits under it, so "auto" picks int8."""
    cfg = load_cell(CELL)["config"]
    layers = _levels(cfg["rows"])
    assert layers[:4] == [800000, 400118, 200157, 99919]
    assert all(n > build_large.LARGE_N for n in layers[:3])
    assert layers[3] <= build_large.LARGE_N
    bf16, int8 = _pack_bytes(cfg["rows"], cfg["index"]["max_M0"], cfg["dim"])
    assert int8 <= PACK_BYTES_CAP < bf16

"""The sift1m.bulk cell's own path on the CPU, at a small size: a traced dry
run whose layers 0-2 take the clustered builder with bf16 products
(LARGE_N and build.F32_BUILD_MAX lowered below them, layer 0 past one cell
of cluster_size 4,096 so that the NN-descent round runs) and whose search
keeps the f32 loop with no pack is correct against the plain reference; the
levels of the configuration's rows put layers 0-2 past LARGE_N and layer 3
below it; the roofline reader's byte count of one G1 call is the table of
its docstring, a row that several slots reach counted once; and the
reader's wrapper sees the same calls in every batch of the eager search.
Imports no JAX: this folder also runs on the card's machine."""

import math
import types

import pytest
import torch

from benchmark import cell, program_trace
from benchmark.cell import Client, run_cell
from benchmark.datagen import make_data
from benchmark.spec import load_cell, load_family, load_reader
from hnsw_tpu_torch.models.hnsw import build, build_large
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.models.hnsw.graph import assign_levels

CELL = "sift1m.bulk"
METRIC = "hop_score_f32_roofline"


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


def _reader_module():
    return load_reader(METRIC).__globals__


def _small(spec, rows=4600, queries=160, batch=32):
    spec["config"] = dict(spec["config"], rows=rows, queries=queries)
    spec["traffic"] = dict(spec["traffic"], batch=batch)
    return spec


def test_traced_dry_run_is_correct(monkeypatch):
    spec = load_cell(CELL)
    cfg = spec["config"]
    assert [m["name"] for m in spec["per_layer"]] == [METRIC]
    assert cfg["metric"] == "euclidean" and cfg["dim"] == 128
    # 4,600 rows x 128: layers 0-2 (4,600, 2,322, 1,183) past LARGE_N, layer
    # 0 past one cell, layer 3 (581) below it, with bf16 products, as at the
    # configuration's rows; one timed build keeps the run short
    monkeypatch.setattr(build_large, "LARGE_N", 1000)
    monkeypatch.setattr(build, "F32_BUILD_MAX", 1000)
    monkeypatch.setattr(cell, "BUILDS", 1)
    monkeypatch.setattr(program_trace, "BUILDS", 1)
    spec = _small(spec)
    res = run_cell(spec, seed=2**31 + 25, seconds=0.5, trace_on=True,
                   device="cpu")
    # no CUDA launch in a CPU window: the reader finds nothing to read
    assert METRIC not in res["metrics"]
    checks = res["checks"]
    assert checks["invalid_answers"]["value"] == 0
    assert checks["max_dist_gap"]["value"] <= \
        cfg["correct"]["max_dist_gap"]
    assert checks["recall_at_10"]["value"] >= \
        cfg["correct"]["recall_at_10"]
    assert res["correct"] is True


def test_three_clustered_layers_at_full_size():
    """The configuration's rows as build_graph draws their levels, with
    LARGE_N and F32_BUILD_MAX as shipped: layers 0-2 take the clustered
    builder, layer 3 the exact one, all with bf16 products."""
    cfg = load_cell(CELL)["config"]
    layers = _levels(cfg["rows"])
    assert all(n > build_large.LARGE_N for n in layers[:3])
    assert layers[3] <= build_large.LARGE_N
    assert cfg["rows"] > build.F32_BUILD_MAX


def test_g1_bytes_count_each_valid_row_once():
    g1_bytes = _reader_module()["g1_bytes"]
    b, c, d = 2, 4, 128
    queries = torch.zeros((b, d))
    vectors = torch.zeros((10, d))
    # rows 3 and 5 valid in both queries, 7 once; 9 is not valid
    rows = torch.tensor([[3, 5, 7, 9], [5, 3, 9, 9]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True, False],
                          [True, True, False, False]])
    want = (3 * (d * 4 + 4)             # rows 3, 5, 7 and their norms
            + b * d * 4 + b * 4         # queries and their norms
            + b * c * (4 + 1)           # int32 ids and bool flags
            + b * c * 4)                # f32 output
    assert g1_bytes(queries, rows, vectors, valid) == want
    # int64 ids and bf16 rows
    want64 = (3 * (d * 2 + 4) + b * d * 4 + b * 4 + b * c * (8 + 1)
              + b * c * 4)
    assert g1_bytes(queries, rows.long(), vectors.bfloat16(), valid) == \
        want64


def test_the_wrapper_counts_every_call_of_each_batch(monkeypatch):
    """The reader's wrapper over the index's eager search (the card's
    fixed-length loop forced): the same calls in every batch, each the byte
    count of its operands, and the answers unchanged."""
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    spec = _small(load_cell(CELL), rows=1200, queries=96)
    cfg = spec["config"]
    corpus, pool = make_data(cfg, 7)
    index = load_family("hnsw").build(corpus, cfg, torch.device("cpu"))
    client = Client(pool, spec["traffic"]["batch"])
    before = load_family("hnsw").search(index, client.queries(1), cfg)
    ctx = types.SimpleNamespace(index=index, client=client, k=cfg["k"],
                                mode=cfg["mode"], ef=cfg["ef"],
                                first_traced=1)
    counted = _reader_module()["_bytes_per_batch"](ctx, 2)
    per = len(counted[0])
    # 62 bodies, the entry seeds and the re-rank
    assert per >= cfg["ef"] // 4 + 12 and len(counted[1]) == per
    assert all(n > 0 for c in counted for n in c)
    after = load_family("hnsw").search(index, client.queries(1), cfg)
    assert all(torch.equal(x, y) for x, y in zip(before, after))

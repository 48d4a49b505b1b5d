"""Dry runs of every cell on the CPU at a tiny size: the result line's keys,
the check's verdict with the timed path broken underneath, and the run's
refusals (no card, a forbidden module, a checkout without the program)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.cell import run_cell
from benchmark.spec import HERE, ROOT, load_benchmark, load_cell
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.models.hnsw import search as hnsw_search

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell):
    spec = load_cell(cell)
    spec["config"] = dict(spec["config"], rows=1000, queries=160)
    spec["traffic"] = dict(spec["traffic"],
                           batch=min(spec["traffic"]["batch"], 32))
    return spec


def dry_run(cell, trace_on=False, seed=2**31 + 99):
    res = run_cell(tiny(cell), seed=seed, seconds=0.5, trace_on=trace_on,
                   device="cpu")
    return json.loads(json.dumps(res))


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_the_result_keys(cell, trace_on):
    res = dry_run(cell, trace_on)
    want = KEYS + (["breakdown"] if trace_on else []) + ["checks"]
    assert sorted(res) == sorted(want)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    spec = load_cell(cell)
    if not trace_on:
        assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    else:
        assert set(res["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def _keep_state(body, state, max_hops, count):
    """A hop loop whose every step returns its state unchanged."""
    return state, None


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    real = HNSWIndex.search_batch
    if fault == "state_unchanged":
        monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                            lambda device: True)
        monkeypatch.setattr(hnsw_search, "_hops_fixed", _keep_state)
    elif fault == "half_batch":
        def half(self, queries, k, *a, **kw):
            h = (len(queries) + 1) // 2
            d, r = real(self, queries[:h], k, *a, **kw)
            fill = torch.arange(len(queries)) % h
            return d[fill], r[fill]
        monkeypatch.setattr(HNSWIndex, "search_batch", half)
    else:
        def altered(self, queries, k, *a, **kw):
            d, r = real(self, queries, k, *a, **kw)
            r = r.clone()
            r[0, 0] = (r[0, 0] + 1) % self.corpus.n
            return d, r
        monkeypatch.setattr(HNSWIndex, "search_batch", altered)
    res = dry_run("bible31k.bulk")
    assert res["correct"] is False


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = run.main(["--workload", CELLS[0], "--seed", str(2**31 + 3),
                     "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hnsw_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hnsw_tpu.fake", sys)
    assert run.forbidden_modules() == ["hnsw_tpu"]


def test_bare_checkout_refuses(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark exits
    non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = load_benchmark()["command"] + [
        "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
        "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable] + cmd[1:], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_p95_is_the_sorted_sample_at_int_095_n():
    from benchmark.cell import p95
    assert p95(list(range(100))) == 95.0
    assert p95([3.0]) == 3.0
    assert p95(np.arange(20)[::-1]) == 19.0

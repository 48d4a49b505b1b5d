"""BENCHMARK.json and the files it names: found by name, and within the
limits of the benchmark's contract (names, units, keys, lengths, budget)."""

import json

import pytest

from benchmark.spec import (HERE, NAME, ROOT, UNIT, load_benchmark,
                            load_cell, load_config, load_family,
                            load_reader, load_traffic)

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    text = e[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for cell in CELLS:
        spec = load_cell(cell)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in names, (cell, m["name"])
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configs_are_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"].startswith("benchmark/configs/")
    cfg = load_config(BENCH, config)
    assert cfg["reduced"] == entry["reduced"] == []
    for key in ("rows", "dim", "metric", "queries", "index", "mode", "ef",
                "k", "correct", "assumed", "data"):
        assert key in cfg
    assert any(w["config"] == config for w in BENCH["workloads"])
    family = load_family(cfg["index"]["family"])
    assert callable(family.build) and callable(family.search)


@pytest.mark.parametrize("cell", CELLS)
def test_cells_find_their_mix(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    mix = load_traffic(w["traffic"])
    assert mix["batch"] >= 1
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(load_reader(metric))


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_config_files_are_json_objects():
    for p in (HERE / "configs").glob("*.json"):
        assert isinstance(json.loads(p.read_text()), dict)

"""The benchmark's description, read from ``BENCHMARK.json`` and the files it
names: a cell's configuration (``configs/<config>.json``), the index family
it names (``families/<family>.py``: how to build and search it), its traffic
mix (``traffic/<traffic>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``, a function ``read(ctx)``). Everything is found by
name, so a new cell, family, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    if cfg["name"] != name:
        raise ValueError(f"{entry['file']} holds {cfg['name']!r}, not {name!r}")
    return cfg


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    if mix["loop"] != "closed" or mix["clients"] != 1 or \
            mix["pool"] != "held_out":
        raise ValueError(f"traffic/{name}.json: the generator drives one "
                         "closed-loop client over the held-out query pool")
    return mix


def _load(folder: str, name: str):
    """The module of <folder>/<name>.py (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """The read(ctx) function of metrics/<metric>.py."""
    return _load("metrics", metric).read


def load_family(family: str):
    """families/<family>.py: build(rows, cfg, device) and
    search(index, queries, cfg) of one index family."""
    return _load("families", family)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell `name` needs: the cell, its configuration,
    its traffic mix, and the end-to-end and per-layer metrics it reports."""
    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], name, "workload")
    return dict(
        cell=cell,
        config=load_config(bench, cell["config"], root),
        traffic=load_traffic(cell["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )

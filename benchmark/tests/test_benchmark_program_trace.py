"""The readers of the program's own spans and counters
(benchmark/program_trace.py) in dry runs on the CPU: the helper's batches
run once a run, whatever the number of readers; every reader gives a number
or None; device tracing is off again afterwards; and a program without the
tracer gives None everywhere."""

import sys

import pytest

from benchmark import program_trace
from benchmark.cell import run_cell
from benchmark.spec import load_benchmark, load_cell, load_reader
from benchmark.tests.test_benchmark_run import CELLS, tiny
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.utils import tracing

PROGRAM = [m["name"] for m in load_benchmark()["per_layer"]
           if m["source"] in ("program_span", "program_counter")]


def traced_dry_run(cell):
    return run_cell(tiny(cell), seed=2**31 + 7, seconds=0.5, trace_on=True,
                    device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_readers_give_numbers_or_none_and_leave_tracing_off(cell,
                                                            monkeypatch):
    reads, traced_calls = [], []
    real_read, real_search = program_trace._read, HNSWIndex.search_batch

    def counting_read(ctx):
        reads.append(ctx)
        return real_read(ctx)

    def counting_search(self, *a, **kw):
        if tracing.device_tracing():
            traced_calls.append(1)
        return real_search(self, *a, **kw)

    monkeypatch.setattr(program_trace, "_read", counting_read)
    monkeypatch.setattr(HNSWIndex, "search_batch", counting_search)
    res = traced_dry_run(cell)
    assert res["correct"] is True
    assert len(reads) == 1
    assert len(traced_calls) == program_trace.BATCHES + 1
    assert not tracing.device_tracing()
    for name in PROGRAM:
        if name in res["metrics"]:
            assert isinstance(res["metrics"][name]["value"], float), name
    # the CPU search runs the early-exit loop: phases, and no counters and
    # no replay (the whole of a dry run's window is traced, so no request
    # span is read either)
    wanted = {m["name"] for m in load_cell(cell)["per_layer"]}
    for name in ("search.event_ms_per_batch", "search.phase.expand_ms",
                 "build.layers_s"):
        assert (name in res["metrics"]) == (name in wanted), name
    for name in ("hop.needed_body_share", "entry.launch_ms"):
        assert name not in res["metrics"], name


def test_without_the_tracer_every_reader_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "hnsw_tpu_torch.utils.tracing", None)
    monkeypatch.delattr("hnsw_tpu_torch.utils.tracing", raising=False)

    class Ctx:
        pass

    ctx = Ctx()
    for name in PROGRAM:
        assert load_reader(name)(ctx) is None, name

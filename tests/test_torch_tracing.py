"""The port's tracer (hnsw_tpu_torch/utils/tracing.py) on the CPU: host spans
(nesting, ids, the ring, the profiler's clock, threads), the device marks
and counters of the search (off: the search is the parent's; on: the same
rows, the phases in order, counters that agree with debug_hops) and the
build's spans. No JAX: on the card this file also runs with
`python -m pytest --noconftest tests/test_torch_tracing.py -q`.
"""

import sys
import threading
import time

import pytest
import torch

from hnsw_tpu_torch.io.datagen import generate_vectors
from hnsw_tpu_torch.models import HNSWIndex, build_hnsw_index
from hnsw_tpu_torch.models.hnsw import search as hnsw_search
from hnsw_tpu_torch.utils import tracing
from hnsw_tpu_torch.utils.graphs import kernel_wrappers

K = 10


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return generate_vectors(1100, 64, distribution="embedding",
                            num_clusters=8, seed=11)


@pytest.fixture(scope="module")
def index(data):
    return build_hnsw_index(data[:1000], M=8, device="cpu")


@pytest.fixture
def fresh():
    """The process's tracer drained, with device tracing off before and
    after the test."""
    tracing.enable_device(False)
    tracing.collect()
    yield tracing.TRACER
    tracing.enable_device(False)
    tracing.collect()


def test_spans_nest_and_carry_parent_and_request_ids():
    tr = tracing.Tracer(ring=64)
    with tr.span("req", batch=3) as root:
        with tr.span("req.a"):
            with tr.span("req.a.x"):
                pass
        with tr.span("req.b"):
            pass
        root.attrs["done"] = True
    with tr.span("other"):
        pass
    spans = {s.name: s for s in tr.collect().spans}
    req, a, x, b = (spans[n] for n in ("req", "req.a", "req.a.x", "req.b"))
    assert (req.parent, req.request) == (0, req.id)
    assert (a.parent, a.request) == (req.id, req.id)
    assert (x.parent, x.request) == (a.id, req.id)
    assert (b.parent, b.request) == (req.id, req.id)
    assert spans["other"].parent == 0
    assert spans["other"].request == spans["other"].id != req.id
    assert req.attrs == {"batch": 3, "done": True}
    assert req.start_ns <= a.start_ns <= x.start_ns <= x.end_ns <= a.end_ns
    assert a.end_ns <= b.start_ns <= b.end_ns <= req.end_ns
    assert len({s.id for s in spans.values()}) == 5


def test_ring_wraps_without_growing_and_totals_count_what_it_dropped():
    tr = tracing.Tracer(ring=16)
    for i in range(40):
        with tr.span("s", i=i):
            pass
    assert len(tr._ring) == 16
    got = tr.collect().spans
    # the newest 16, oldest first; the other 24 dropped but counted
    assert [s.attrs["i"] for s in got] == list(range(24, 40))
    assert tr.dropped == 24
    assert tr.totals()["s"]["count"] == 40
    assert tr.totals()["s"]["ns"] >= sum(s.end_ns - s.start_ns for s in got)
    for i in range(5):
        with tr.span("t", i=i):
            pass
    assert [s.attrs["i"] for s in tr.collect().spans] == list(range(5))
    assert tr.collect().spans == [] and tr.dropped == 24
    assert len(tr._ring) == 16
    with pytest.raises(ValueError):
        tracing.Tracer(ring=24)


def test_span_lines_up_with_its_profiler_event(fresh):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("hnsw.test.aligned"):
            time.sleep(0.005)
    span = next(s for s in tracing.collect().spans
                if s.name == "hnsw.test.aligned")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "hnsw.test.aligned"]
    assert len(events) == 1
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    assert abs(span.start_ns - start) < 1_000_000
    assert abs(span.end_ns - end) < 1_000_000
    assert span.end_ns - span.start_ns >= 5_000_000


def test_spans_of_many_threads_are_all_counted(fresh):
    """More threads than cores, a short switch interval: every span is in
    the totals and in the ring once, each with its own thread's parent."""
    tr = tracing.Tracer(ring=1 << 14)
    threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                with tr.span("root", t=t):
                    with tr.span("child", t=t):
                        pass
        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    spans = tr.collect().spans
    assert len(spans) == 2 * threads * per and tr.dropped == 0
    assert len({s.id for s in spans}) == len(spans)
    roots = {s.id: s for s in spans if s.name == "root"}
    for s in spans:
        if s.name == "child":
            assert roots[s.parent].attrs["t"] == s.attrs["t"]
    totals = tr.totals()
    assert totals["root"]["count"] == totals["child"]["count"] == \
        threads * per


def test_search_batch_records_its_spans(fresh, index, data):
    index.search_batch(data[1000:1016], K, "balanced")
    spans = tracing.collect().spans
    root = next(s for s in spans if s.name == "hnsw.search")
    assert root.attrs == {"batch": 16, "captured": False}
    children = {s.name for s in spans if s.request == root.id
                and s.parent == root.id}
    assert {"hnsw.search.pad", "hnsw.search.prepare"} <= children
    # no capture and no replay off the card
    assert not {"hnsw.search.capture", "hnsw.search.replay"} & children


# the key the search of the module's index had before device tracing: k,
# ef, precision, hierarchy, expand, rerank_mult, pack, loop dim, debug_hops
PARENT_KEY = (K, 200, "default", False, 4, 4, "bf16", 128, False)


def test_device_tracing_off_leaves_the_search_as_it_was(fresh, index, data):
    q = index.corpus.pad_queries(data[1000:1032])
    run, key = index._search_fn(K, "balanced", None, False)
    assert key == PARENT_KEY
    before = [w.launches for w in kernel_wrappers()]
    d, r, hops = run(q)
    d2, r2 = index.search_batch(data[1000:1032], K, "balanced")
    assert torch.equal(r, r2) and torch.equal(d, d2)
    assert [w.launches for w in kernel_wrappers()] == before
    got = tracing.collect()
    assert got.runs == 0 and not any(got.phase_ms.values())
    assert not any(got.counters.values())


def test_device_tracing_on_gives_the_same_rows_and_phases_in_order(
        fresh, index, data, monkeypatch):
    q = data[1000:1032]
    d0, r0, h0 = index.search_batch(q, K, "balanced", debug_hops=True)
    seq = []
    real = tracing.mark
    monkeypatch.setattr(tracing, "mark",
                        lambda p, dev: seq.append(p) or real(p, dev))
    tracing.enable_device(True)
    run, key = index._search_fn(K, "balanced", None, False)
    assert key == PARENT_KEY + ("device_tracing",)
    d1, r1, h1 = index.search_batch(q, K, "balanced", debug_hops=True)
    got = tracing.collect()
    assert torch.equal(r0, r1) and torch.equal(d0, d1) and h0 == h1
    # the entry twice (the run, then the search it calls: one phase), the
    # first body's select, one expand / score / merge (with the next
    # body's select) a body, the re-rank, the end
    body = ["expand", "score", "merge"]
    assert seq == ["entry", "entry", "select"] + body * h1 + [
        "rerank", tracing.END]
    assert got.runs == 1
    assert all(got.phase_ms[p] > 0 for p in ("entry", "select", "expand",
                                             "score", "merge", "rerank"))
    assert got.phase_ms["dequant"] == 0   # the int8 pack's phase alone
    assert got.phase_ms["count"] == 0     # the CPU loop counts nothing


def test_counters_agree_with_debug_hops(fresh, index, data, monkeypatch):
    """The card's fixed-length loop, forced on the CPU: hop.bodies_needed is
    debug_hops's trip count, and the shares stay within their bases."""
    monkeypatch.setattr(hnsw_search, "_runs_fixed_length",
                        lambda device: True)
    q = data[1000:1048]
    d0, r0, h0 = index.search_batch(q, K, "balanced", debug_hops=True)
    tracing.enable_device(True)
    d1, r1, h1 = index.search_batch(q, K, "balanced", debug_hops=True)
    index.search_batch(q, K, "balanced")
    got = tracing.collect()
    assert torch.equal(r0, r1) and torch.equal(d0, d1) and h0 == h1
    c = got.counters
    max_hops = 200 // 4 + 12
    b, slots = len(q), len(q) * 4 * index.graph.m0
    assert got.runs == 2
    assert c["hop.bodies_run"] == 2 * max_hops
    assert c["hop.bodies_needed"] == 2 * h1
    assert 0 < c["hop.query_bodies_active"] <= b * c["hop.bodies_run"]
    assert c["hop.slots_scored"] == 2 * max_hops * slots
    assert 0 < c["hop.slots_valid"] <= c["hop.slots_scored"]
    assert got.phase_ms["count"] > 0
    # a body is a no-op once its queries stopped, so every active query
    # body expands up to E rows of M0 slots
    assert c["hop.slots_valid"] <= c["hop.query_bodies_active"] * 4 * \
        index.graph.m0


def test_collect_hands_each_run_out_once(fresh, index, data):
    tracing.enable_device(True)
    for i in range(3):
        index.search_batch(data[1000 + 8 * i:1008 + 8 * i], K, "balanced")
    first = tracing.collect()
    assert first.runs == 3
    second = tracing.collect()
    assert second.runs == 0 and not any(second.phase_ms.values())
    index.search_batch(data[1000:1008], K, "balanced")
    third = tracing.collect()
    assert third.runs == 1
    assert sum(third.phase_ms.values()) < sum(first.phase_ms.values())


def test_marks_and_counts_record_nothing_while_off(fresh):
    cpu = torch.device("cpu")
    tracing.mark("entry", cpu)
    tracing.count("hop.test", torch.ones((), dtype=torch.int64))
    tracing.mark(tracing.END, cpu)
    got = tracing.collect()
    assert got.runs == 0 and "hop.test" not in got.counters
    tracing.enable_device(True)
    tracing.mark("entry", cpu)
    tracing.mark("entry", cpu)            # a phase marked while open goes on
    tracing.count("hop.test", torch.tensor(3))
    tracing.count("hop.test", 4, cpu)
    tracing.mark("select", cpu)
    tracing.mark(tracing.END, cpu)
    got = tracing.collect()
    assert got.runs == 1 and got.counters["hop.test"] == 7
    assert got.phase_ms["entry"] > 0 and got.phase_ms["merge"] == 0


def test_build_records_its_stage_spans(fresh, data):
    build_hnsw_index(data[:600], M=8, device="cpu")
    spans = tracing.collect().spans
    root = next(s for s in spans if s.name == "hnsw.build")
    assert root.attrs == {"rows": 600, "metric": "cosine"}
    assert root.parent == 0
    stages = {s.name: s for s in spans if s.parent == root.id}
    assert list(stages) == ["hnsw.build.layers", "hnsw.build.fetch",
                            "hnsw.build.repair"]
    for s in stages.values():
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert stages["hnsw.build.layers"].end_ns <= \
        stages["hnsw.build.fetch"].start_ns
    assert stages["hnsw.build.fetch"].end_ns <= \
        stages["hnsw.build.repair"].start_ns


@pytest.mark.parametrize("metric,f32_max,precision", [
    ("cosine", None, "bf16"),
    ("euclidean", None, "highest"),
    ("euclidean", 1000, "bf16"),
])
def test_build_spans_name_the_metric_and_the_precision(
        fresh, data, monkeypatch, metric, f32_max, precision):
    """hnsw.build names the metric, and each hnsw.build.large the metric and
    the products' precision its layer took under build_precision "auto":
    bf16 for cosine; for euclidean f32 up to build.F32_BUILD_MAX rows and
    bf16 past it (lowered here, as a million rows pass it)."""
    from hnsw_tpu_torch.models.hnsw import build, build_large
    monkeypatch.setattr(build_large, "LARGE_N", 500)
    if f32_max is not None:
        monkeypatch.setattr(build, "F32_BUILD_MAX", f32_max)
    build_hnsw_index(data, M=8, metric=metric, device="cpu")
    spans = tracing.collect().spans
    (root,) = [s for s in spans if s.name == "hnsw.build"]
    assert root.attrs == {"rows": len(data), "metric": metric}
    large = [s for s in spans if s.name == "hnsw.build.large"]
    # layers 0 and 1 (1,100 and about 550 rows) pass LARGE_N
    assert len(large) == 2
    for s in large:
        assert (s.attrs["metric"], s.attrs["precision"]) == (metric,
                                                             precision)


STAGES = ("kmeans", "cells", "symmetrize", "refine")


def test_clustered_layer_records_its_stage_spans(fresh, data, monkeypatch):
    """A layer past LARGE_N records hnsw.build.large with the plan's counts
    inside hnsw.build.clustered_l0, inside hnsw.build.layers, and under it
    the four stages in order, once each, each closing after its wait for
    the device."""
    from hnsw_tpu_torch.models.hnsw import build_large
    monkeypatch.setattr(build_large, "LARGE_N", 1000)
    real_build, real_wait = (build_large.build_layer_clustered,
                             build_large._wait)
    monkeypatch.setattr(build_large, "build_layer_clustered",
                        lambda *a, **kw: real_build(*a, cluster_size=512,
                                                    **kw))
    waited = []

    def wait(dev):
        waited.append(tracing.TRACER._local.spans[-1].name)
        real_wait(dev)

    monkeypatch.setattr(build_large, "_wait", wait)
    build_hnsw_index(data, M=8, device="cpu")
    spans = tracing.collect().spans
    root = next(s for s in spans if s.name == "hnsw.build")
    layers = next(s for s in spans if s.name == "hnsw.build.layers")
    large = [s for s in spans if s.name == "hnsw.build.large"]
    assert len(large) == 1
    large = large[0]
    (clustered,) = [s for s in spans
                    if s.name == "hnsw.build.clustered_l0"]
    assert large.parent == clustered.id and clustered.parent == layers.id
    assert layers.parent == root.id and large.request == root.id
    assert large.attrs["rows"] == len(data) and large.attrs["cells"] == 2
    plan = {"rows", "cells", "largest_pool", "pool_pad", "cell_chunk_rows",
            "refine_chunk_rows", "tile"}
    assert set(large.attrs) == plan | {"metric", "precision"}
    assert all(isinstance(large.attrs[k], int) and large.attrs[k] > 0
               for k in plan)
    # the route the layer took: cosine rows build with bf16 products
    assert (large.attrs["metric"], large.attrs["precision"]) == \
        ("cosine", "bf16")
    stages = [s for s in spans if s.parent == large.id]
    names = ["hnsw.build.large." + st for st in STAGES]
    assert [s.name for s in stages] == names
    assert waited == names
    assert stages[-1].attrs == {"rounds": 1}
    assert large.start_ns <= stages[0].start_ns
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    assert stages[-1].end_ns <= large.end_ns <= clustered.end_ns <= \
        layers.end_ns
    # benchmark/program_trace.py keys a build's spans by their last name
    # part: no two of one build share one
    parts = [s.name.rsplit(".", 1)[-1] for s in spans
             if s.request == root.id and s.parent]
    assert len(parts) == len(set(parts))
    assert {"layers", "fetch", "repair", "clustered_l0", "large",
            *STAGES} == set(parts)

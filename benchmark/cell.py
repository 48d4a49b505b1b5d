"""One run of one cell: set-up, the measured window, the traced readings and
the check of every answer the window returned.

Set-up makes the corpus and the query pool from the seed, builds an index
of its first rows to warm the process, builds the index with the
configuration's family (``families/<family>.py``) ``BUILDS`` times
(their mean: the per-layer ``build.seconds``), and warms up the
cell's one batch shape, whose first call captures the search in a CUDA
graph. The window is a closed loop of one client: the next batch, a slice of
the pool that wraps round so that every batch is full, is sent as host
float32 rows when the last answers are on the host, and a request is timed
from the call of the family's search to its rows and distances copied
to the host (for HNSW, from the call of ``HNSWIndex.search_batch``). The
window runs from the first call to the last answer.

A traced run (``trace_on``) also profiles the last ``TRACE_SECONDS`` of
the window (the requests before them are timed untraced) and, after the
window, one more build of the same rows, and hands both, with the window's
spans, to the per-layer readers. After the window the peak device memory is
read, the readers run, the program's state is freed, and the plain
reference judges every answer.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import List, NamedTuple

import numpy as np
import torch

from benchmark import reference, trace
from benchmark.datagen import make_data
from benchmark.spec import load_family, load_reader

# seconds of the window the profiler records in a traced run: a few hundred
# thousand device events, which the readers reduce in seconds
TRACE_SECONDS = 3.0
# calls of the cell's batch shape before the window: the first captures
WARMUP_CALLS = 3
# rows of the build that warms the process before the timed ones: the first
# build in a process also loads the kernels it launches and sets up the
# libraries (on the card: 3.7 s against 1.2 s for the second build of the
# same rows), so build.seconds times the build alone
WARMUP_BUILD_ROWS = 2048
# timed builds of the whole corpus, build.seconds their mean: the build
# waits on the host, and one build of the same rows in one process varies
# by +-15% on the card's shared host
BUILDS = 3
REQUEST = trace.SPAN + "request"
PREPARE = trace.SPAN + "prepare"
BUILD = trace.SPAN + "build"


class Request(NamedTuple):
    t0: float        # the call of search_batch
    t_ret: float     # its return, before the answers are waited for
    t_done: float    # rows and distances on the host


class Client:
    """Batches of `batch` rows of the query pool, in order, wrapping round.
    `queries` copies the batch's one or two runs of pool rows into one
    buffer, which the search has copied to the device by the time it
    returns, so the loop allocates nothing a request."""

    def __init__(self, pool: np.ndarray, batch: int):
        if not 0 < batch <= len(pool):
            raise ValueError(f"a batch of {batch} from a pool of {len(pool)}")
        self.pool, self.batch = pool, batch
        self.buf = np.empty((batch, pool.shape[1]), pool.dtype)

    def rows(self, i: int) -> np.ndarray:
        return (i * self.batch + np.arange(self.batch)) % len(self.pool)

    def queries(self, i: int) -> np.ndarray:
        s = i * self.batch % len(self.pool)
        m = min(self.batch, len(self.pool) - s)
        self.buf[:m] = self.pool[s:s + m]
        self.buf[m:] = self.pool[:self.batch - m]
        return self.buf


class Context:
    """What a per-layer reader sees: the traced window of the search
    (`window`, a trace.Window, or None), that of the build (`build`), the
    mean seconds of the set-up's builds (`build_s`), every
    request of the window (`requests`), the first traced one
    (`first_traced`; those before it ran untraced) and how many the trace
    holds (`traced`), and, to recount operands after the window, the index,
    the client and the search's arguments."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def p95(samples_ms) -> float:
    """The 95th percentile as the program's bench/harness.py:latency_report
    takes it: the sorted sample at int(0.95 n)."""
    s = np.sort(np.asarray(samples_ms, np.float64))
    return float(s[min(int(len(s) * 0.95), len(s) - 1)])


def _trace_cost(requests, first):
    """Print the mean request of the untraced and the traced part of a
    traced window: what the profiler costs."""
    def mean_ms(rs):
        return (sum(r.t_done - r.t0 for r in rs) * 1e3 / len(rs)
                if rs else float("nan"))
    print(f"trace: {first} untraced requests, mean {mean_ms(requests[:first])}"
          f" ms; {len(requests) - first} traced, mean "
          f"{mean_ms(requests[first:])} ms", file=sys.stderr)


def _traced_build(build, corpus, dev):
    """The build once more under the profiler, after the window: a profiler
    leaves the card's graph launches slower for the rest of the process, so
    nothing timed comes after it."""
    prof = _profiler(dev)
    prof.start()
    with _span(BUILD, True):
        build(corpus)
        _sync(dev)
    prof.stop()
    return _window(prof, BUILD)


def _window(prof, span):
    device, host = trace.split_events(prof)
    bounds = trace.span_window(host, span)
    return None if bounds is None else trace.Window(device, host, *bounds)


def run_cell(spec: dict, *, seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: float = None) -> dict:
    """One run. Returns the result line's fields (correct, attempted, failed,
    metrics, device, breakdown when traced, checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = spec["config"], spec["traffic"]
    dev = torch.device(device)
    k, mode, ef = cfg["k"], cfg["mode"], cfg["ef"]
    family = load_family(cfg["index"]["family"])
    corpus, pool = make_data(cfg, seed)

    def build(rows):
        return family.build(rows, cfg, dev)

    build(corpus[:WARMUP_BUILD_ROWS])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(BUILDS):
        index = None                 # the last build's memory is reused
        index = build(corpus)
        _sync(dev)
    build_s = (time.perf_counter() - t0) / BUILDS

    client = Client(pool, mix["batch"])

    def request(i):
        d, r = family.search(index, client.queries(i), cfg)
        return d.cpu().numpy(), r.cpu().numpy()

    for i in range(WARMUP_CALLS):
        request(i)
    gc.collect()
    gc.disable()          # no collector pause inside the window
    setup_s = time.perf_counter() - t_start

    # ---- the measured window -------------------------------------------
    # a traced run profiles its last TRACE_SECONDS, counted from when the
    # profiler is up (its first start in a process takes seconds); the
    # requests before them are timed untraced
    requests: List[Request] = []
    answers = []
    prof = _profiler(dev) if trace_on else None
    trace_from = max(seconds - TRACE_SECONDS, 0.0)
    first_traced = None
    i = 0
    w0 = time.perf_counter()
    end = w0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if prof and first_traced is None and now - w0 >= trace_from:
            prof.start()
            first_traced = len(requests)
            end = time.perf_counter() + min(TRACE_SECONDS, seconds)
        tracing = first_traced is not None
        with _span(PREPARE, tracing):
            q = client.queries(i)
        with _span(REQUEST, tracing):
            t0 = time.perf_counter()
            d, r = family.search(index, q, cfg)
            t_ret = time.perf_counter()
            d, r = d.cpu().numpy(), r.cpu().numpy()
            t_done = time.perf_counter()
        requests.append(Request(t0, t_ret, t_done))
        answers.append((d, r))
        i += 1
    window_s = requests[-1].t_done - w0
    gc.enable()
    if first_traced is not None:
        prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    build_window = _traced_build(build, corpus, dev) if trace_on else None

    # ---- per-layer readers, while the program's state lives ------------
    metrics, traced_info, breakdown = {}, {}, None
    if trace_on:
        started = first_traced is not None
        first_traced = first_traced if started else len(requests)
        w = _window(prof, REQUEST) if started else None
        ctx = Context(window=w, build=build_window, build_s=build_s,
                      requests=requests, first_traced=first_traced,
                      traced=len(requests) - first_traced, index=index,
                      client=client, k=k, mode=mode, ef=ef)
        _trace_cost(requests, first_traced)
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        traced_info = dict(busy_s=float(w.busy_s) if w else 0.0,
                           window_s=float(w.seconds) if w else 0.0)
        if w is not None:
            breakdown = dict(device_ops=w.top_ops(), idle_gaps=w.idle_gaps())
        del ctx, w
    del index, request, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check -----------------------------------------------------
    qidx = np.concatenate([client.rows(j) for j in range(len(answers))])
    dists = np.concatenate([a[0] for a in answers])
    rows = np.concatenate([a[1] for a in answers]).astype(np.int64)
    verdict = reference.judge(corpus, pool, qidx, rows, dists, k=k,
                              metric=cfg["metric"], device=dev)
    limits = cfg["correct"]
    checks = {
        "invalid_answers": {"value": verdict["invalid_answers"], "limit": 0},
        "max_dist_gap": {"value": verdict["max_dist_gap"],
                         "limit": limits["max_dist_gap"]},
        "recall_at_10": {"value": verdict["recall_at_10"],
                         "limit": limits["recall_at_10"]},
    }
    correct = (len(requests) > 0
               and verdict["invalid_answers"] == 0
               and verdict["max_dist_gap"] <= limits["max_dist_gap"]
               and verdict["recall_at_10"] >= limits["recall_at_10"])
    failed = int(verdict["invalid"].reshape(len(answers), -1).any(1).sum())

    if not trace_on:
        values = dict(
            qps=len(qidx) / window_s,
            p95_ms=p95([(r.t_done - r.t0) * 1e3 for r in requests]),
            recall_at_10=verdict["recall_at_10"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else dev.type),
        count=spec["cell"]["chips"], memory_peak_bytes=int(memory_peak))
    dev_info.update(traced_info)
    result = dict(correct=bool(correct), attempted=len(requests),
                  failed=failed, metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result

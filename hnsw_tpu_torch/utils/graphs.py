"""Capture a function of CUDA tensors in one CUDA graph and replay it.

A search that never waits on the host (``models/hnsw/search.py`` on the
card) can be recorded once in a ``torch.cuda.CUDAGraph`` and replayed: a
replay launches the whole recorded sequence at once, with no Python and no
per-operator host work. ``CapturedCall`` does that for one set of input
shapes. Any operator that waits on the host makes the capture raise, and
the error is left to the caller.

Launch counts. The kernel wrappers count a launch in Python
(``wrapper.launches``; ``hop_score_int8.narrow_launches`` also counts those
that took its narrow plan). A call made during capture launches nothing and
a replay runs no Python, so the capture takes back what its calls counted,
keeps it as the counts the graph holds, and each replay adds them.

Spans. A call records ``hnsw.search.replay`` (the static copies, the replay's
launch and the launch counts) and ``hnsw.search.clone`` (the outputs'
clones) on the port's tracer (``utils/tracing.py``): the graph replays the
HNSW search.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.utils import tracing


# the counts a kernel wrapper keeps
COUNTS = ("launches", "narrow_launches")


def kernel_wrappers():
    """Every wrapper of a hand-written kernel, each with its `launches`."""
    from hnsw_tpu_torch.ops import (descent, expand, gather, hop, merge,
                                    probes, scan)
    return (hop.hop_score, hop.hop_score_int8, expand.hop_expand,
            merge.hop_merge, gather.hop_gather_score, descent.greedy_descent,
            scan.bucket_topk, scan.int8_bucket_topk, scan.exact_topk_sweep,
            scan.int8_sweep_topk, scan.int8_packed_topk, probes.mm_only,
            probes.mm_only_nt, probes.mm_only_kmajor, probes.matmul_only,
            probes.matmul_min, tracing.stamp)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(x) for x in out)
    return out


class CapturedCall:
    """fn(*inputs) recorded once in a CUDA graph over static copies of
    `inputs` (CUDA tensors), after one eager run on a side stream, which
    does whatever one-time work fn has (kernel builds, attributes, caches).
    Each call copies its inputs, of the captured shapes, into the static
    buffers, replays, and returns clones of the outputs, so that a later
    replay does not overwrite an earlier result. fn must hold references to
    every other tensor it reads, so that none is freed while the graph
    lives."""

    def __init__(self, fn, *inputs):
        dev = inputs[0].device
        self.static_in = tuple(x.clone() for x in inputs)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self.static_in)
            torch.cuda.current_stream().wait_stream(side)
            counts = [(w, a) for w in kernel_wrappers() for a in COUNTS
                      if hasattr(w, a)]
            before = [getattr(w, a) for w, a in counts]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.static_out = fn(*self.static_in)
        self.fn = fn
        # (wrapper, count, what the graph holds of it), and of `launches`
        # alone (wrapper, launches the graph holds)
        self.counts = []
        for (w, a), n in zip(counts, before):
            if getattr(w, a) != n:
                self.counts.append((w, a, getattr(w, a) - n))
                setattr(w, a, n)
        self.launches = [(w, n) for w, a, n in self.counts if a == "launches"]

    def __call__(self, *inputs):
        with tracing.span("hnsw.search.replay"):
            for static, x in zip(self.static_in, inputs):
                if x.shape != static.shape:
                    raise ValueError("captured for shape "
                                     f"{tuple(static.shape)}, given "
                                     f"{tuple(x.shape)}")
                static.copy_(x)
            self.graph.replay()
            for w, a, n in self.counts:
                setattr(w, a, getattr(w, a) + n)
        with tracing.span("hnsw.search.clone"):
            return _clone(self.static_out)

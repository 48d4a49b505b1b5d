"""The one owner of what the hop loop scores against
(hnsw_tpu_torch/models/hnsw/shadow.py), on the CPU; no JAX.

1. The route each caller gets: precision, pack kind, loop width and the
   operands themselves, for HNSWIndex and both multi-entry families
   (IVF-HNSW, partitioned HNSW), as each picked them before the owner
   existed: cosine -> bf16 loop and bf16 pack; euclidean -> f32 with no
   shadow and no pack; a cap below the bf16 pack -> int8 for HNSWIndex and
   no pack for the families; pack_dim -> the projected shadow; pack=False ->
   the bf16 gather.
2. A pack_dim that is not a multiple of 16 is widened with zero columns,
   which the hop kernels and the descent take on the card.
3. The cache: kept while nothing changes; a changed pack_precision and
   add_batch rebuild it and empty the captured searches; the wave insert
   takes its precision from the same rule.
"""

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.models import (build_hnsw_index, build_ivf_hnsw_index,
                                   build_partitioned_hnsw, ivf_hnsw,
                                   partitioned)
from hnsw_tpu_torch.models.hnsw import shadow
from hnsw_tpu_torch.models.hnsw.shadow import HopShadow, loop_precision

N, DIM = 600, 48


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(n=N, seed=3):
    x = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def built():
    """One HNSW graph per metric, on the CPU."""
    return {m: build_hnsw_index(_data(), M=8, metric=m, device="cpu")
            for m in ("cosine", "euclidean")}


def _cap_between_int8_and_bf16(adj0, width):
    rows = adj0.shape[0] * adj0.shape[1]
    return rows * (width + 8 + width * 2 + 4) // 2


# settings -> (precision, pack kind, loop width, shadow width or None)
ROUTES = {
    "cosine": (dict(), ("default", "bf16", 128, 128)),
    "euclidean": (dict(metric="euclidean"), ("highest", None, 128, None)),
    "cap_below_bf16": (dict(cap="small"), ("default", "int8", 128, 128)),
    "pack_dim": (dict(pack_dim=32), ("default", "bf16", 32, 32)),
    "pack_dim_100": (dict(pack_dim=100), ("default", "bf16", 112, 112)),
    "no_pack": (dict(pack=False), ("default", None, 128, 128)),
    "highest": (dict(precision="highest"), ("highest", None, 128, None)),
    "int8": (dict(pack_precision="int8"), ("default", "int8", 128, 128)),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_hnsw_index_takes_the_parents_route(case, built, monkeypatch):
    kw, (precision, pack, width, shadow_width) = ROUTES[case]
    kw = dict(kw)
    idx = built[kw.pop("metric", "cosine")]
    if kw.pop("cap", None):
        monkeypatch.setitem(HopShadow.prepare.__kwdefaults__, "cap",
                            _cap_between_int8_and_bf16(idx.graph.adj0, 128))
    for name in ("precision", "pack", "pack_precision", "pack_dim"):
        monkeypatch.setattr(idx, name, kw.get(name, getattr(idx, name)))
    monkeypatch.setattr(idx, "_shadow", HopShadow())
    run, key = idx._search_fn(10, "balanced", None, False)
    assert key[2] == precision and key[6] == pack and key[7] == width
    own = idx._shadow
    if shadow_width is None:
        assert own.vectors_lp is None and own.nbr_pack is None
    else:
        assert own.vectors_lp.dtype == torch.bfloat16
        assert tuple(own.vectors_lp.shape) == (idx.graph.n_pad,
                                               shadow_width)
    lowdim = "pack_dim" in kw
    assert (own.proj is not None) == lowdim
    assert (own.v_sq_lp is not None) == lowdim
    if pack is None:
        assert own.nbr_pack is None
    else:
        want = torch.int8 if pack == "int8" else torch.bfloat16
        assert own.nbr_pack.dtype == want
        assert tuple(own.nbr_pack.shape) == (idx.graph.n_pad, idx.graph.m0,
                                             width)
        assert (own.nbr_scale is not None) == (pack == "int8")
    d, r, _ = run(idx.corpus.pad_queries(_data(16, seed=9)))
    assert (r >= 0).all()


def _family(name, metric):
    data = _data()
    if name == "ivf_hnsw":
        return build_ivf_hnsw_index(data, num_partitions=4, M=8,
                                    metric=metric, device="cpu")
    return build_partitioned_hnsw(data, num_partitions=2, M=8, metric=metric,
                                  device="cpu")


@pytest.mark.parametrize("name", ["ivf_hnsw", "partitioned_hnsw"])
@pytest.mark.parametrize("case", ["cosine", "euclidean", "cap_below_bf16"])
def test_families_take_a_bf16_pack_or_none(name, case, monkeypatch):
    """IVF-HNSW and partitioned HNSW: bf16 loop for cosine, with a bf16 pack
    while it fits the cap and none past it (never int8); f32 for
    euclidean."""
    idx = _family(name, "euclidean" if case == "euclidean" else "cosine")
    adj0 = idx.adj0 if name == "ivf_hnsw" else idx._globalized()
    if case == "cap_below_bf16":
        module = ivf_hnsw if name == "ivf_hnsw" else partitioned
        monkeypatch.setattr(module, "PACK_BYTES_CAP",
                            _cap_between_int8_and_bf16(adj0, 128))
    d, r = idx.search_batch(_data(16, seed=9), 10, "balanced")
    assert (r >= 0).all()
    own = idx._shadow
    if case == "euclidean":
        assert own.vectors_lp is None and own.nbr_pack is None
    elif case == "cap_below_bf16":
        assert own.vectors_lp.dtype == torch.bfloat16
        assert own.nbr_pack is None
    else:
        assert own.nbr_pack.dtype == torch.bfloat16
        assert own.nbr_scale is None and own.proj is None


def test_pack_dim_off_16_is_widened_with_zero_columns(built):
    idx = built["cosine"]
    own = HopShadow()
    route = own.prepare(idx.corpus, idx.graph.adj0, pack_dim=100,
                        pack_precision="int8")
    assert route.loop_dim == 112 and route.pack == "int8"
    assert torch.equal(own.proj[:, 100:], torch.zeros_like(own.proj[:, 100:]))
    assert not own.vectors_lp[:, 100:].any()
    assert not own.nbr_pack[..., 100:].any()
    # the zero columns add nothing to the norms of the 100 projected ones
    low = own.vectors_lp[:, :100].float()
    torch.testing.assert_close(own.v_sq_lp, (low * low).sum(-1))
    assert route.proj is own.proj and own.proj.shape == (128, 112)
    # a basis of the top 100 axes, widest variance first
    var = (torch.matmul(idx.corpus.vectors, own.proj) ** 2).sum(0)
    assert (var[:99] >= var[1:100] * (1 - 1e-4)).all()


@pytest.mark.parametrize("metric,precision,want", [
    ("cosine", "auto", "default"), ("euclidean", "auto", "highest"),
    ("dot", "auto", "highest"), ("euclidean", "default", "default"),
    ("cosine", "highest", "highest")])
def test_one_precision_rule(metric, precision, want):
    assert loop_precision(metric, precision) == want


def test_cache_is_kept_until_a_setting_or_the_index_changes(monkeypatch):
    idx = build_hnsw_index(_data(), M=8, device="cpu")
    q = _data(16, seed=9)
    idx.search_batch(q, 10)
    pack = idx._shadow.nbr_pack
    idx._graphs["captured"] = object()
    idx.search_batch(q, 10)
    assert idx._shadow.nbr_pack is pack and len(idx._graphs) == 1
    # a setting changed on the built index: a new pack, no old graph
    idx.pack_precision = "int8"
    idx.search_batch(q, 10)
    assert idx._shadow.nbr_pack.dtype == torch.int8
    assert len(idx._graphs) == 0
    # add_batch: a new owner, no old graph, and the wave insert's search
    # takes its precision from the one rule
    idx._graphs["captured"] = object()
    calls = []
    real = shadow.loop_precision
    monkeypatch.setattr(shadow, "loop_precision",
                        lambda *a: calls.append(a) or real(*a))
    old = idx._shadow
    idx.add_batch(_data(40, seed=11))
    assert calls and len(idx._graphs) == 0
    assert idx._shadow is not old and idx._shadow.nbr_pack is None
    d, r = idx.search_batch(_data(40, seed=11), 1)
    assert (r[:, 0] >= N).float().mean() >= 0.9
    assert idx._shadow.nbr_pack.shape[0] == idx.graph.n_pad

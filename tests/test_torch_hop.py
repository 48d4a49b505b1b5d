"""Port of the hop-scoring kernels (hnsw_tpu_torch/ops/hop.py).

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX Pallas kernels (ops/pallas_hop.py) in interpret mode at the
shapes of tests/test_pallas_hop.py: tb == b, tb < b (grid > 1), a ring
deeper than the tile, B not a multiple of 8, and negative rows.

Tolerances: both sides round the query to bf16 and form exact bf16 x bf16
(or bf16 x int8) products in f32; only the order of the f32 sums differs.
So the bounds below are far tighter than test_pallas_hop.py's
(dots atol 2e-1 / rtol 2e-2 against a float reference).

The CUDA kernels themselves are compared with these plain versions on the
card by chip_smoke.py and by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hnsw_tpu.ops.pallas_hop import hop_score as j_hop_score
from hnsw_tpu.ops.pallas_hop import hop_score_int8 as j_hop_score_int8

from hnsw_tpu_torch.ops import hop

DOT_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bf16_inputs(seed, n, m0, d, b, e):
    rng = np.random.default_rng(seed)
    pack = jnp.asarray(rng.standard_normal((n, m0, d)), jnp.bfloat16)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sel = rng.integers(0, n, (b, e)).astype(np.int32)
    tpack = torch.from_numpy(np.array(pack.astype(jnp.float32))).to(
        torch.bfloat16)
    return pack, q, sel, tpack


@pytest.mark.parametrize("b,tb,ring", [(64, 16, 8), (16, 16, 32), (13, 8, 3)])
def test_hop_score_matches_pallas(b, tb, ring):
    pack, q, sel, tpack = _bf16_inputs(3, 256, 8, 128, b, 4)
    jd, jc = j_hop_score(pack, jnp.asarray(q), jnp.asarray(sel), tb=tb,
                         ring=ring, interpret=True)
    td, tc = hop.hop_score(tpack, _t(q), _t(sel))
    assert td.shape == (b, 4 * 8) and tc.shape == (b, 4 * 8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **DOT_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


def test_hop_score_clamps_negative_rows():
    pack, q, sel, tpack = _bf16_inputs(4, 64, 8, 128, 8, 2)
    sel[::3, 0] = -1
    jd, jc = j_hop_score(pack, jnp.asarray(q), jnp.asarray(sel),
                         interpret=True)
    td, tc = hop.hop_score(tpack, _t(q), _t(sel))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **DOT_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    # a negative row reads row 0, never the last row
    row0 = hop.hop_score(tpack, _t(q), torch.zeros_like(_t(sel)))[0]
    neg = np.repeat(sel < 0, 8, axis=1)
    np.testing.assert_array_equal(td.numpy()[neg], row0.numpy()[neg])


@pytest.mark.parametrize("b,tb,ring", [(64, 16, 8), (21, 8, 2)])
def test_hop_score_int8_matches_pallas(b, tb, ring):
    rng = np.random.default_rng(5)
    n, m0, d, e = 128, 32, 128, 4
    codes = rng.integers(-127, 128, (n, m0, d)).astype(np.int8)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sel = rng.integers(-1, n, (b, e)).astype(np.int32)
    jd = j_hop_score_int8(jnp.asarray(codes), jnp.asarray(q),
                          jnp.asarray(sel), tb=tb, ring=ring, interpret=True)
    td = hop.hop_score_int8(_t(codes), _t(q), _t(sel))
    assert td.shape == (b, e * m0)
    # dots of magnitude ~127*sqrt(d): the f32 sum-order bound scales with it
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=5e-2)


def test_cpu_tensors_take_the_plain_version_only():
    pack, q, sel, tpack = _bf16_inputs(6, 32, 8, 128, 4, 2)
    before = (hop.hop_score.launches, hop.hop_score_int8.launches)
    d1, c1 = hop.hop_score(tpack, _t(q), _t(sel))
    d2, c2 = hop.hop_score_plain(tpack, _t(q), _t(sel))
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    codes = torch.zeros((32, 8, 128), dtype=torch.int8)
    assert torch.equal(hop.hop_score_int8(codes, _t(q), _t(sel)),
                       hop.hop_score_int8_plain(codes, _t(q), _t(sel)))
    # the launch counts move only where a CUDA kernel is launched
    assert (hop.hop_score.launches, hop.hop_score_int8.launches) == before


def test_non_cpu_tensors_never_fall_back():
    # a tensor that is neither on the CPU nor on a CUDA card is refused by
    # the kernel wrapper's checks instead of taking the plain version
    pack = torch.empty((32, 8, 128), dtype=torch.bfloat16, device="meta")
    q = torch.empty((4, 128), device="meta")
    sel = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hop.hop_score(pack, q, sel)
    with pytest.raises(ValueError):
        hop.hop_score_int8(pack.to(torch.int8), q, sel)


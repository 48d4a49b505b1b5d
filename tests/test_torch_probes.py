"""Port of the matmul floors (hnsw_tpu_torch/ops/probes.py) against the TPU
probe kernels, on the CPU.

The probe scripts hold the Pallas kernels. scripts/_probe_r5a.py and
scripts/_probe_r5c.py guard their main(), so they are imported and their
matmul_only / matmul_min run with pl.pallas_call in interpret mode (patched
for the test); importing them enables the JAX compilation cache
(.jax_cache/, git-ignored), whose settings are put back afterwards.
scripts/_probe_r4e.py and scripts/_probe_r4f.py run on import, so this file
carries verbatim copies of their kernels (cited by line) and runs those in
interpret mode.

Tolerances: the int8 floors are exact int32 dots, so they must agree bit for
bit; the bf16 floors are exact bf16 products summed in f32 in another order
(per 128-row group and tile there, per 1024-row tile here), held to
1e-5 * max |out|.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hnsw_tpu_torch.ops import probes

REPO = pathlib.Path(__file__).resolve().parent.parent
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


def _load(name):
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call in interpret mode for the duration of a test."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16)


def _torch_bf16(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# B10 / B11: int8 floors, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,d,nt,bt", [(16, 1024, 256, 512, 8),
                                         (24, 1536, 128, 256, 8)])
def test_int8_floors_match_the_probe_kernels(interpret, b, n, d, nt, bt):
    r5a, r5c = _load("_probe_r5a"), _load("_probe_r5c")
    q8, v8 = _int8((b, d), 1), _int8((n, d), 2)
    vkey = jnp.ones((n,), jnp.float32)
    want_only = np.asarray(r5a.matmul_only(jnp.asarray(v8), vkey,
                                           jnp.asarray(q8), n, bt=bt, nt=nt))
    want_min = np.asarray(r5c.matmul_min(jnp.asarray(v8), vkey,
                                         jnp.asarray(q8), n, bt=bt, nt=nt))
    tq, tv = torch.from_numpy(q8), torch.from_numpy(v8)
    before = (probes.matmul_only.launches, probes.matmul_min.launches)
    got_only = probes.matmul_only(tq, tv, nt=nt)
    got_min = probes.matmul_min(tq, tv, nt=nt)
    assert got_only.dtype == got_min.dtype == torch.int32
    np.testing.assert_array_equal(got_only.numpy(), want_only)
    np.testing.assert_array_equal(got_min.numpy(), want_min)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (probes.matmul_only.launches, probes.matmul_min.launches) == before


def test_int8_floors_keep_the_last_tile_of_a_ragged_corpus():
    """The TPU grid visits n // nt tiles and leaves the last one's result;
    rows past the last whole tile are not visited."""
    q8, v8 = _int8((5, 128), 3), _int8((1300, 128), 4)
    got = probes.matmul_min(torch.from_numpy(q8), torch.from_numpy(v8),
                            nt=512).numpy()
    dots = q8.astype(np.int64) @ v8[512:1024].astype(np.int64).T
    np.testing.assert_array_equal(got, dots.reshape(5, 4, 128).min(1))
    got = probes.matmul_only(torch.from_numpy(q8), torch.from_numpy(v8),
                             nt=512).numpy()
    np.testing.assert_array_equal(got, dots[:, :128])
    with pytest.raises(ValueError, match="nt"):
        probes.matmul_min(torch.from_numpy(q8), torch.from_numpy(v8), nt=200)
    with pytest.raises(ValueError, match="nt"):
        probes.matmul_only(torch.from_numpy(q8), torch.from_numpy(v8[:100]),
                           nt=128)


# ---------------------------------------------------------------------------
# B8 / B9: bf16 floors, verbatim copies of the probes' kernels
# ---------------------------------------------------------------------------

# scripts/_probe_r4e.py:107-130, verbatim (bt = B = 1024 is built into the
# kernel's reshape)
def mm_kernel(q_ref, v_ref, acc_ref):
    ti = pl.program_id(1)

    @pl.when(ti == 0)
    def _():
        acc_ref[:] = jnp.zeros(acc_ref.shape, jnp.float32)
    dots = jnp.dot(q_ref[:], v_ref[:].T,
                   preferred_element_type=jnp.float32)
    # cheapest possible reduction epilogue: accumulate row sums
    acc_ref[:] += jnp.sum(dots.reshape(1024, -1, 128), axis=1)


@functools.partial(jax.jit, static_argnames=("nt",))
def mm_only(vec, q, *, nt):
    grid = (1, vec.shape[0] // nt)
    return pl.pallas_call(
        mm_kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((1024, vec.shape[1]), lambda bi, ti: (bi, 0)),
            pl.BlockSpec((nt, vec.shape[1]), lambda bi, ti: (ti, 0)),
        ],
        out_specs=pl.BlockSpec((1024, 128), lambda bi, ti: (bi, 0)),
        out_shape=jax.ShapeDtypeStruct((1024, 128), jnp.float32),
    )(q, vec)


def r4f_mm_only(vec, vecT, q, bt, nt, kmajor):
    """scripts/_probe_r4f.py:95-149 (mm_only_factory), verbatim inside this
    function, which supplies the script's globals B, vec, vecT and q."""
    B = q.shape[0]

    def mm_only_factory(bt, nt, kmajor):
        if kmajor:
            def kernel(q_ref, v_ref, acc_ref):
                ti = pl.program_id(1)

                @pl.when(ti == 0)
                def _():
                    acc_ref[:] = jnp.zeros(acc_ref.shape, jnp.float32)
                dots = jax.lax.dot_general(
                    q_ref[:], v_ref[:], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
                acc_ref[:] += jnp.sum(dots.reshape(bt, -1, 128), axis=1)

            @jax.jit
            def run(vecT, q):
                return pl.pallas_call(
                    kernel,
                    grid=(B // bt, vecT.shape[1] // nt),
                    in_specs=[
                        pl.BlockSpec((bt, vecT.shape[0]), lambda bi, ti: (bi, 0)),
                        pl.BlockSpec((vecT.shape[0], nt), lambda bi, ti: (0, ti)),
                    ],
                    out_specs=pl.BlockSpec((bt, 128), lambda bi, ti: (bi, 0)),
                    out_shape=jax.ShapeDtypeStruct((B, 128), jnp.float32),
                    compiler_params=pltpu.CompilerParams(
                        dimension_semantics=("parallel", "arbitrary")),
                )(q, vecT)
            return lambda: run(vecT, q)
        else:
            def kernel(q_ref, v_ref, acc_ref):
                ti = pl.program_id(1)

                @pl.when(ti == 0)
                def _():
                    acc_ref[:] = jnp.zeros(acc_ref.shape, jnp.float32)
                dots = jax.lax.dot_general(
                    q_ref[:], v_ref[:], (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32)
                acc_ref[:] += jnp.sum(dots.reshape(bt, -1, 128), axis=1)

            @jax.jit
            def run(vec, q):
                return pl.pallas_call(
                    kernel,
                    grid=(B // bt, vec.shape[0] // nt),
                    in_specs=[
                        pl.BlockSpec((bt, vec.shape[1]), lambda bi, ti: (bi, 0)),
                        pl.BlockSpec((nt, vec.shape[1]), lambda bi, ti: (ti, 0)),
                    ],
                    out_specs=pl.BlockSpec((bt, 128), lambda bi, ti: (bi, 0)),
                    out_shape=jax.ShapeDtypeStruct((B, 128), jnp.float32),
                    compiler_params=pltpu.CompilerParams(
                        dimension_semantics=("parallel", "arbitrary")),
                )(q, vec)
            return lambda: run(vec, q)

    return mm_only_factory(bt, nt, kmajor)()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bf16_floor_matches_r4e(interpret):
    q, vec = _bf16((1024, 128), 5), _bf16((2048, 128), 6)
    want = mm_only(vec, q, nt=1024)
    _close(probes.mm_only(_torch_bf16(q), _torch_bf16(vec)), want)


@pytest.mark.parametrize("kmajor", [False, True])
@pytest.mark.parametrize("bt,nt", [(16, 512), (32, 256)])
def test_bf16_floors_match_r4f(interpret, kmajor, bt, nt):
    q, vec = _bf16((32, 256), 7), _bf16((1024, 256), 8)
    vecT = jnp.asarray(vec.T)
    want = r4f_mm_only(vec, vecT, q, bt, nt, kmajor)
    tq = _torch_bf16(q)
    got = (probes.mm_only_kmajor(tq, _torch_bf16(vecT)) if kmajor
           else probes.mm_only_nt(tq, _torch_bf16(vec)))
    _close(got, want)


def test_bf16_floor_sums_every_row_of_a_ragged_corpus():
    q = torch.randn(3, 64).to(torch.bfloat16)
    v = torch.randn(300, 64).to(torch.bfloat16)
    dots = q.double() @ v.double().T
    want = torch.nn.functional.pad(dots, (0, 84)).reshape(3, 3, 128).sum(1)
    np.testing.assert_allclose(probes.mm_only(q, v).numpy(), want.numpy(),
                               rtol=0, atol=1e-5 * float(want.abs().max()))
    np.testing.assert_array_equal(
        probes.mm_only_kmajor(q, v.T.contiguous()).numpy(),
        probes.mm_only(q, v).numpy())

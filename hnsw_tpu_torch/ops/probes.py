"""Matmul floors of the flat scans. Counterpart of the TPU probe kernels in
``scripts/_probe_r4e.py`` (``mm_only``), ``scripts/_probe_r4f.py``
(``mm_only_factory``, NT and K-major), ``scripts/_probe_r5a.py``
(``matmul_only``) and ``scripts/_probe_r5c.py`` (``matmul_min``).

Each is a scan's product loop with a trivial epilogue, so the time of a scan
kernel minus its floor is what its selection or distance epilogue costs:

- ``mm_only(q, v)``, ``mm_only_nt(q, v)`` (bf16, v [N, D]) and
  ``mm_only_kmajor(q, vT)`` (vT [D, N]): out[b, j] = sum over the rows r with
  r mod 128 == j of q_b . v_r, f32 [B, 128].
- ``matmul_only(q8, v8, *, nt)`` (int8): out[b, j] = q8_b . v8[N_t - nt + j],
  int32 [B, 128], with N_t = (N // nt) * nt: the first 128 dots of the last
  nt-row tile, which is what the TPU grid leaves in its output block. The
  products of every tile are formed all the same.
- ``matmul_min(q8, v8, *, nt)``: out[b, j] = min over s < nt / 128 of
  q8_b . v8[N_t - nt + 128 s + j], the corrected floor of ``_probe_r5c.py``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/probes.cu``, the tile loop of ``csrc/tile.cuh``) or raises; on a CPU
tensor it runs its plain version, which walks the corpus in tiles as the TPU
grid does. ``mm_only`` and ``mm_only_nt`` launch the same kernel (the TPU's
``mm_only`` is ``mm_only_factory`` at bt = B = 1024); each keeps its own
launch count.
"""

from __future__ import annotations

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.scan import _splits

KPAD = 128
# corpus rows per tile of the plain bf16 floor (the probes' nt)
PLAIN_NT = 1024


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _colsum_plain(q, v_rows, n: int):
    """Sum over PLAIN_NT-row tiles of the [B, nt] products folded by
    r mod 128. v_rows(lo, hi) gives corpus rows [lo, hi) as f32 [hi - lo, D]."""
    qf = q.float()
    b = q.shape[0]
    acc = torch.zeros((b, KPAD), dtype=torch.float32, device=q.device)
    for lo in range(0, n, PLAIN_NT):
        hi = min(lo + PLAIN_NT, n)
        dots = torch.matmul(qf, v_rows(lo, hi).T)     # exact bf16 products
        pad = (-(hi - lo)) % KPAD
        if pad:
            dots = torch.nn.functional.pad(dots, (0, pad))
        acc += dots.reshape(b, -1, KPAD).sum(dim=1)
    return acc


def mm_only_plain(q, v):
    """Plain version of the bf16 floor: q [B, D], v [N, D] -> f32 [B, 128]."""
    return _colsum_plain(q, lambda lo, hi: v[lo:hi].float(), v.shape[0])


def mm_only_kmajor_plain(q, vT):
    """Plain version of the K-major bf16 floor: q [B, D], vT [D, N]."""
    return _colsum_plain(q, lambda lo, hi: vT[:, lo:hi].float().T,
                         vT.shape[1])


def _last_tile_plain(q8, v8, nt: int, take_min: bool):
    _check_last_tile(q8, v8, nt)
    qf = q8.float()
    out = None
    for ti in range(v8.shape[0] // nt):
        # s8 x s8 dots of D <= 1040 stay below 2^24: exact in f32
        dots = torch.matmul(qf, v8[ti * nt:(ti + 1) * nt].float().T)
        out = (dots.reshape(q8.shape[0], nt // KPAD, KPAD).amin(dim=1)
               if take_min else dots[:, :KPAD])
    return out.to(torch.int32)


def matmul_only_plain(q8, v8, *, nt: int):
    """Plain version of the int8 store floor: int32 [B, 128]."""
    return _last_tile_plain(q8, v8, nt, take_min=False)


def matmul_min_plain(q8, v8, *, nt: int):
    """Plain version of the int8 min floor: int32 [B, 128]."""
    return _last_tile_plain(q8, v8, nt, take_min=True)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        _cuda.require(t.is_cuda and t.device == dev,
                      "all tensors must be on one CUDA device")
        _cuda.require(t.dtype == dtype, f"the floors take {dtype} tensors")
        _cuda.require(t.ndim == 2 and t.is_contiguous()
                      and t.data_ptr() % 16 == 0,
                      "tensors must be 2-d, contiguous and 16-byte aligned")
    return dev


def _check_last_tile(q8, v8, nt: int):
    if nt < KPAD or nt % KPAD or v8.shape[0] < nt:
        raise ValueError(f"need nt a multiple of {KPAD} and N >= nt, got "
                         f"nt={nt}, N={v8.shape[0]}")
    if q8.shape[1] != v8.shape[1]:
        raise ValueError(f"q8 [B, {q8.shape[1]}] against v8 [N, {v8.shape[1]}]")


def _launch_colsum(q, v, kmajor: bool, counter):
    dev = _check([q, v], torch.bfloat16)
    d = q.shape[1]
    n = v.shape[1] if kmajor else v.shape[0]
    _cuda.require(v.shape[0 if kmajor else 1] == d,
                  "the corpus and the queries must share D")
    _cuda.require((2 * d) % 128 == 0, "rows must be a multiple of 128 bytes")
    pad = (-n) % KPAD
    if pad:
        # zero rows add nothing to a column sum
        v = torch.nn.functional.pad(v, (0, pad) if kmajor else (0, 0, 0, pad))
        n += pad
    b = q.shape[0]
    splits = _splits(-(-b // 64), n // KPAD, dev)
    out = torch.empty((b, KPAD), dtype=torch.float32, device=dev)
    part = out if splits == 1 else torch.empty((splits, b, KPAD),
                                               dtype=torch.float32, device=dev)
    code = _cuda.library("probes.cu").colsum_bf16(
        v.data_ptr(), q.data_ptr(), part.data_ptr(), out.data_ptr(), b, n, d,
        int(kmajor), splits, _cuda.stream_ptr(dev))
    _cuda.check(code, counter.__name__)
    counter.launches += 1
    return out


def _launch_last_tile(q8, v8, nt: int, take_min: bool, counter):
    dev = _check([q8, v8], torch.int8)
    _check_last_tile(q8, v8, nt)
    d = q8.shape[1]
    _cuda.require(d % 128 == 0, "rows must be a multiple of 128 bytes")
    n_used = (v8.shape[0] // nt) * nt
    b = q8.shape[0]
    splits = _splits(-(-b // 64), n_used // nt, dev)
    out = torch.empty((b, KPAD), dtype=torch.int32, device=dev)
    code = _cuda.library("probes.cu").last_tile_int8(
        v8.data_ptr(), q8.data_ptr(), out.data_ptr(), b, n_used, d, nt,
        int(take_min), splits, _cuda.stream_ptr(dev))
    _cuda.check(code, counter.__name__)
    counter.launches += 1
    return out


def mm_only(q, v):
    """The bf16 floor (``_probe_r4e.py::mm_only``): q [B, D] bf16, v [N, D]
    bf16 -> f32 [B, 128]."""
    if v.device.type == "cpu":
        return mm_only_plain(q, v)
    return _launch_colsum(q, v, False, mm_only)


def mm_only_nt(q, v):
    """The NT variant of ``_probe_r4f.py::mm_only_factory``: the same
    function and kernel as mm_only, counted on its own."""
    if v.device.type == "cpu":
        return mm_only_plain(q, v)
    return _launch_colsum(q, v, False, mm_only_nt)


def mm_only_kmajor(q, vT):
    """The K-major variant of ``_probe_r4f.py::mm_only_factory``: the corpus
    as vT [D, N] bf16 (the "NN" product) -> f32 [B, 128]."""
    if vT.device.type == "cpu":
        return mm_only_kmajor_plain(q, vT)
    return _launch_colsum(q, vT, True, mm_only_kmajor)


def matmul_only(q8, v8, *, nt: int):
    """The int8 store floor (``_probe_r5a.py::matmul_only``): q8 [B, D],
    v8 [N, D] int8 -> int32 [B, 128]."""
    if v8.device.type == "cpu":
        return matmul_only_plain(q8, v8, nt=nt)
    return _launch_last_tile(q8, v8, nt, False, matmul_only)


def matmul_min(q8, v8, *, nt: int):
    """The int8 min floor (``_probe_r5c.py::matmul_min``) -> int32 [B, 128]."""
    if v8.device.type == "cpu":
        return matmul_min_plain(q8, v8, nt=nt)
    return _launch_last_tile(q8, v8, nt, True, matmul_min)


# launch counts: incremented where a kernel is launched, nowhere else
mm_only.launches = 0
mm_only_nt.launches = 0
mm_only_kmajor.launches = 0
matmul_only.launches = 0
matmul_min.launches = 0

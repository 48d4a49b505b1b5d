"""Vectorized bitonic sort / top-k merge. Counterpart of
``hnsw_tpu/ops/sort.py``.

The batched bitonic network written with reshapes, flips and ``torch.where``
only: every stage is a static lane permutation plus an elementwise min/max
over the whole [B, L] tile. The reference keeps it for contexts that could
fuse the stages and as the network its tests pin down; here it backs
``merge="bitonic"`` of the HNSW beam merge (models/hnsw/search.py), whose
default is one stable sort.

Values ride along as one integer payload; ties break by lane position, so
the key/payload pairing stays consistent between exchange partners and the
outputs are the reference's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _exchange(keys, vals, stride: int, block: int):
    """One bitonic compare-exchange stage over the last axis: lanes i and
    i ^ stride swap so that ascending blocks of size `block` form."""
    n = keys.shape[-1]
    lead = keys.shape[:-1]
    # partner view: swap the two halves of each 2*stride group
    k2 = keys.reshape(*lead, n // (2 * stride), 2, stride)
    v2 = vals.reshape(*lead, n // (2 * stride), 2, stride)
    pk = torch.flip(k2, dims=(-2,)).reshape(*lead, n)
    pv = torch.flip(v2, dims=(-2,)).reshape(*lead, n)

    idx = torch.arange(n, device=keys.device)
    is_low = (idx & stride) == 0            # lane is the low element of pair
    asc = (idx & block) == 0                # block sorts ascending
    keep_min = is_low == asc                # this lane keeps the smaller key

    # tie-break by lane position so both partners make consistent choices
    partner_low = ~is_low
    mine_smaller = (keys < pk) | ((keys == pk) & partner_low)
    take_mine = keep_min == mine_smaller
    return torch.where(take_mine, keys, pk), torch.where(take_mine, vals, pv)


def bitonic_sort_kv(keys, vals):
    """Ascending sort of the last axis (power-of-two length) carrying one
    payload array. keys: [..., L] float; vals: [..., L] integer."""
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic length must be a power of two, got {n}")
    size = 2
    while size <= n:
        stride = size // 2
        while stride >= 1:
            keys, vals = _exchange(keys, vals, stride, size)
            stride //= 2
        size *= 2
    return keys, vals


def _pad_to(keys, vals, p: int, fill_key):
    """Pad the last axis to length p: keys with fill_key, payloads with -1."""
    n = keys.shape[-1]
    if p == n:
        return keys, vals
    return (F.pad(keys, (0, p - n), value=fill_key),
            F.pad(vals, (0, p - n), value=-1))


def _pad_pow2(keys, vals, fill_key):
    n = keys.shape[-1]
    p = 1
    while p < n:
        p *= 2
    return _pad_to(keys, vals, p, fill_key)


def bitonic_topk(keys, vals, k: int):
    """Smallest-k of the last axis with payload: pad to a power of two with
    +inf keys / -1 payloads, full bitonic sort, slice k."""
    keys, vals = _pad_pow2(keys, vals, float("inf"))
    keys, vals = bitonic_sort_kv(keys, vals)
    return keys[..., :k], vals[..., :k]


def bitonic_topk_presorted(keys_a, vals_a, keys_b, vals_b, k: int):
    """Smallest-k of [sorted run a ++ unsorted b] with payload.

    The HNSW beam merge shape: `a` (the beam) is already ascending, only `b`
    (the hop candidates) is unsorted. Sort b alone, then one bitonic merge
    phase. Both runs pad to a common power-of-two length with +inf keys /
    -1 payloads."""
    big = float("inf")
    keys_a, vals_a = _pad_pow2(keys_a, vals_a, big)
    keys_b, vals_b = _pad_pow2(keys_b, vals_b, big)
    n = max(keys_a.shape[-1], keys_b.shape[-1])
    keys_a, vals_a = _pad_to(keys_a, vals_a, n, big)
    keys_b, vals_b = _pad_to(keys_b, vals_b, n, big)
    keys_b, vals_b = bitonic_sort_kv(keys_b, vals_b)
    mk, mv = bitonic_merge_sorted(keys_a, vals_a, keys_b, vals_b)
    return mk[..., :k], mv[..., :k]


def bitonic_merge_sorted(keys_a, vals_a, keys_b, vals_b):
    """Merge two ascending runs of equal power-of-two length L into one
    ascending run of 2L (one bitonic merge phase: log2(2L) stages)."""
    n = keys_a.shape[-1]
    # reverse b so [a, reversed(b)] is bitonic
    keys = torch.cat([keys_a, torch.flip(keys_b, dims=(-1,))], dim=-1)
    vals = torch.cat([vals_a, torch.flip(vals_b, dims=(-1,))], dim=-1)
    size = 2 * n
    stride = size // 2
    while stride >= 1:
        keys, vals = _exchange(keys, vals, stride, size * 2)
        stride //= 2
    return keys, vals

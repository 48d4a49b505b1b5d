"""Fused flat scans (bf16 and int8). Counterpart of
``hnsw_tpu/ops/pallas_scan.py``.

Bucketed scans (``pallas_bucket_topk``, ``pallas_int8_bucket_topk``,
``pallas_int8_packed_topk``): per query, a monotone key is formed for every
corpus row (cosine: -dots/|v|; euclidean: |v|^2 - 2 dots; dot: -dots, with
the int8 dequantisation scales folded in), and the best TWO rows of each of
KPAD=128 buckets (bucket = row mod 128) are kept in a [B, 256] bank. The
exact top-k of the bank is then taken outside the kernel and distances are
rebuilt from the key. A true top-k row is lost only when three or more of
the top k share a bucket. The packed variant (int8 cosine/dot) biases the
key positive and carries the row's group in the low bits of its int32 bits,
so the best two are two payload-free int32 minima.

Sweep scans (``pallas_exact_topk``, ``pallas_int8_topk``): the full metric
distance per element and an exact running top-k (k <= 32).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/scan.cu``, ``csrc/sweep.cu``; bound by tensor-core operations, see the
notes there) or raises; on a CPU tensor it runs its plain version, the same
algorithm in plain PyTorch, tile by tile as the TPU kernel walks its corpus
tiles.
"""

from __future__ import annotations

import math

import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.distance import BIG
from hnsw_tpu_torch.ops.topk import top_k_ascending
from hnsw_tpu_torch.types import Metric

# query / corpus tile sizes of the reference's default call shapes; the
# wrappers keep its shape contract (n_pad % nt == 0, b % bt == 0) and the
# plain version walks the corpus in tiles of nt
DEFAULT_BT = 512
DEFAULT_NT = 1024
INT8_BT = 256
INT8_NT = 2048
# buckets per bank half
KPAD = 128
INT_BIG = 2 ** 30
# packed keys: the bias keeps |key| < PACK_BIAS keys positive (cosine:
# |key| <= 127*sqrt(d) < 16384 for d <= 8192), so their int32 bits order like
# them; 0x7F000000 (1.7e38 as f32, finite) sorts after every biased key
PACK_BIAS = 16384.0
INVALID_PACKED = 0x7F000000

_METRIC_CODE = {Metric.COSINE: 0, Metric.EUCLIDEAN: 1, Metric.DOT: 2}


def supported(k: int) -> bool:
    """k range served by the fused scans (larger k takes the exact f32 scan,
    as in the reference)."""
    return 1 <= k <= 32


# ---------------------------------------------------------------------------
# plain version: the reference's tile loop
# ---------------------------------------------------------------------------

def _bucket_min2(key, rows, g: int, c: int):
    """Per-bucket (best, second-best) of key [BT, g*c] with payload rows.
    Bucket b holds lanes {b, c+b, 2c+b, ...}. Returns d1, r1, d2, r2 [BT, c]."""
    bt = key.shape[0]
    k3 = key.reshape(bt, g, c)
    r3 = rows.reshape(bt, g, c)
    d1 = torch.amin(k3, dim=1)
    is1 = k3 == d1[:, None, :]
    r1 = torch.amin(torch.where(is1, r3, INT_BIG), dim=1)
    killed = r3 == r1[:, None, :]          # row ids unique within a tile
    k3b = torch.where(killed, BIG, k3)
    d2 = torch.amin(k3b, dim=1)
    is2 = k3b == d2[:, None, :]
    r2 = torch.amin(torch.where(is2, r3, INT_BIG), dim=1)
    r1 = torch.where(r1 == INT_BIG, -1, r1)
    r2 = torch.where(r2 == INT_BIG, -1, r2)
    return d1, r1, d2, r2


def _merge_pair2(a1, ai1, a2, ai2, b1, bi1, b2, bi2):
    """Smallest two of {a1, a2, b1, b2} (a1 <= a2, b1 <= b2), elementwise;
    a (the earlier rows) wins a tie on the first comparison."""
    a_first = a1 <= b1
    n1 = torch.where(a_first, a1, b1)
    ni1 = torch.where(a_first, ai1, bi1)
    mid = torch.where(a_first, b1, a1)
    mi = torch.where(a_first, bi1, ai1)
    o2 = torch.minimum(a2, b2)
    oi2 = torch.where(a2 <= b2, ai2, bi2)
    n2 = torch.where(mid <= o2, mid, o2)
    ni2 = torch.where(mid <= o2, mi, oi2)
    return n1, ni1, n2, ni2


def _bank_plain(key_tile, n_pad: int, b: int, n: int, nt: int, device):
    c = KPAD
    bank_d = torch.full((b, 2 * c), BIG, dtype=torch.float32, device=device)
    bank_r = torch.full((b, 2 * c), -1, dtype=torch.int32, device=device)
    cols = torch.arange(nt, dtype=torch.int32, device=device)
    for ti in range(n_pad // nt):
        key = key_tile(ti * nt, (ti + 1) * nt)              # [B, nt]
        rows = (ti * nt + cols).expand(b, nt)
        key = torch.where(rows < n, key, BIG)
        t1, tr1, t2, tr2 = _bucket_min2(key, rows, nt // c, c)
        n1, ni1, n2, ni2 = _merge_pair2(bank_d[:, :c], bank_r[:, :c],
                                        bank_d[:, c:], bank_r[:, c:],
                                        t1, tr1, t2, tr2)
        bank_d = torch.cat([n1, n2], dim=1)
        bank_r = torch.cat([ni1, ni2], dim=1)
    return bank_d, bank_r


def bucket_bank_plain(vectors, vkey, queries, n, *, metric: Metric,
                      nt: int = DEFAULT_NT):
    """Plain version of the bf16 bank: vectors [N_pad, D] bf16, vkey [N_pad]
    f32 (1/|v| cosine, |v|^2 euclidean, unused for dot), queries [B, D] bf16.
    Returns (bank keys f32 [B, 256], bank rows int32 [B, 256])."""
    metric = Metric.coerce(metric)
    qf = queries.float()

    def key_tile(lo, hi):
        dots = torch.matmul(qf, vectors[lo:hi].float().T)   # exact widening
        vk = vkey[lo:hi][None, :]
        if metric == Metric.COSINE:
            return -dots * vk
        if metric == Metric.EUCLIDEAN:
            return vk - 2.0 * dots
        return -dots

    return _bank_plain(key_tile, vectors.shape[0], queries.shape[0], int(n),
                       nt, vectors.device)


def int8_bucket_bank_plain(v8, vkey, vscale, q8, qscale, n, *,
                           metric: Metric, nt: int = INT8_NT):
    """Plain version of the int8 bank: v8 [N_pad, D] int8, vkey [N_pad]
    (vscale/|v| cosine, |v|^2 euclidean, vscale dot), vscale [N_pad],
    q8 [B, D] int8, qscale [B]. int8 x int8 dots of D <= 1040 stay below
    2^24, so the f32 product below is the exact int32 dot."""
    metric = Metric.coerce(metric)
    qf = q8.float()
    qs = qscale.float()[:, None]

    def key_tile(lo, hi):
        dots = torch.matmul(qf, v8[lo:hi].float().T)
        vk = vkey[lo:hi][None, :]
        if metric == Metric.EUCLIDEAN:
            return vk - 2.0 * qs * vscale[lo:hi][None, :] * dots
        return -dots * vk

    return _bank_plain(key_tile, v8.shape[0], q8.shape[0], int(n), nt,
                       v8.device)


def _group_bits(nt: int):
    """Groups of 128 rows per nt-row tile, and the low key bits that carry
    the group id in the packed scan."""
    g = nt // KPAD
    return g, max((g - 1).bit_length(), 1)


def int8_packed_bank_plain(v8, nvkey, q8, n, *, nt: int = INT8_NT):
    """Plain version of the packed int8 bank (cosine/dot): v8 [N_pad, D]
    int8, nvkey [N_pad] f32 (the negated int8 vkey: -vscale/|v| cosine,
    -vscale dot), q8 [B, D] int8. Per nt-row tile: key = dots*nvkey +
    PACK_BIAS; its int32 bits with the low gbits bits replaced by the group
    index; rows >= n get INVALID_PACKED; two payload-free int32 minima per
    bucket; decode; fold into the bank with _merge_pair2. Returns (biased
    keys f32 [B, 256], rows int32 [B, 256])."""
    c = KPAD
    g, gbits = _group_bits(nt)
    gmask = (1 << gbits) - 1
    n = int(n)
    n_pad = v8.shape[0]
    b = q8.shape[0]
    dev = v8.device
    qf = q8.float()
    bank_d = torch.full((b, 2 * c), BIG, dtype=torch.float32, device=dev)
    bank_r = torch.full((b, 2 * c), -1, dtype=torch.int32, device=dev)
    gi = torch.arange(g, dtype=torch.int32, device=dev).reshape(1, g, 1)
    j = gi * c + torch.arange(c, dtype=torch.int32, device=dev).reshape(1, 1, c)
    lane = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    for ti in range(n_pad // nt):
        lo = ti * nt
        dots = torch.matmul(qf, v8[lo:lo + nt].float().T)   # exact int dots
        key = dots * nvkey[lo:lo + nt][None, :] + PACK_BIAS
        si = key.view(torch.int32).reshape(b, g, c)
        si = (si & ~gmask) | gi
        si = torch.where(lo + j < n, si, INVALID_PACKED)
        b1 = torch.amin(si, dim=1)
        b2 = torch.amin(torch.where(si == b1[:, None, :], INVALID_PACKED, si),
                        dim=1)

        def decode(p):
            kf = (p & ~gmask).view(torch.float32)
            row = lo + (p & gmask) * c + lane
            ok = p < INVALID_PACKED
            return torch.where(ok, kf, BIG), torch.where(ok, row, -1)

        t1, tr1 = decode(b1)
        t2, tr2 = decode(b2)
        n1, ni1, n2, ni2 = _merge_pair2(bank_d[:, :c], bank_r[:, :c],
                                        bank_d[:, c:], bank_r[:, c:],
                                        t1, tr1, t2, tr2)
        bank_d = torch.cat([n1, n2], dim=1)
        bank_r = torch.cat([ni1, ni2], dim=1)
    return bank_d, bank_r


def _tile_topk(dist, rows, k: int):
    """k masked min sweeps over [BT, NT]; the winner is selected and masked
    by its (unique) row id. Returns ([BT, k], [BT, k])."""
    ds, rs = [], []
    for _ in range(k):
        m = torch.amin(dist, dim=1, keepdim=True)
        is_min = dist == m
        r = torch.amin(torch.where(is_min, rows, INT_BIG), dim=1, keepdim=True)
        ds.append(m)
        rs.append(torch.where(r == INT_BIG, -1, r))
        dist = torch.where(rows == r, BIG, dist)
    return torch.cat(ds, dim=1), torch.cat(rs, dim=1)


def _merge_sorted(cand_d, cand_r, k: int):
    """Ascending k smallest of [BT, 2k] pairs via k min sweeps; invalid
    slots carry row -1 and dist BIG."""
    ds, rs = [], []
    rows = torch.where(cand_r >= 0, cand_r, INT_BIG)
    for _ in range(k):
        m = torch.amin(cand_d, dim=1, keepdim=True)
        is_min = cand_d == m
        r = torch.amin(torch.where(is_min, rows, INT_BIG), dim=1, keepdim=True)
        ds.append(m)
        rs.append(torch.where(r == INT_BIG, -1, r))
        kill = (rows == r) & is_min
        cand_d = torch.where(kill, BIG, cand_d)
        rows = torch.where(kill, INT_BIG, rows)
    return torch.cat(ds, dim=1), torch.cat(rs, dim=1)


def _sweep_plain(dist_tile, n_pad: int, b: int, n: int, k: int, nt: int,
                 device):
    out_d = torch.full((b, k), BIG, dtype=torch.float32, device=device)
    out_r = torch.full((b, k), -1, dtype=torch.int32, device=device)
    cols = torch.arange(nt, dtype=torch.int32, device=device)
    for ti in range(n_pad // nt):
        dist = dist_tile(ti * nt, (ti + 1) * nt)            # [B, nt]
        rows = (ti * nt + cols).expand(b, nt)
        dist = torch.where(rows < n, dist, BIG)
        tile_d, tile_r = _tile_topk(dist, rows, k)
        mer_d, mer_r = _merge_sorted(torch.cat([out_d, tile_d], dim=1),
                                     torch.cat([out_r, tile_r], dim=1), k)
        out_d = mer_d
        out_r = torch.where(mer_d < BIG, mer_r, -1)
    return out_d, out_r


def _sweep_distance(dots, q_sq, v_sq, metric: Metric):
    if metric == Metric.COSINE:
        denom = torch.sqrt(torch.clamp(q_sq * v_sq, min=1e-12))
        return 1.0 - dots / denom
    if metric == Metric.EUCLIDEAN:
        return torch.sqrt(torch.clamp(q_sq + v_sq - 2.0 * dots, min=0.0))
    return -dots


def exact_topk_sweep_plain(vectors, v_sq, queries, n, *, k: int,
                           metric: Metric, nt: int = DEFAULT_NT):
    """Plain version of the bf16 sweep: vectors [N_pad, D] bf16 (or f32),
    v_sq [N_pad] f32 exact, queries [B, D] of the same dtype. |q|^2 is summed
    from the (bf16) queries as given. Returns (dists f32 [B, k], rows int32
    [B, k])."""
    metric = Metric.coerce(metric)
    qf = queries.float()
    q_sq = torch.sum(qf ** 2, dim=1, keepdim=True)

    def dist_tile(lo, hi):
        dots = torch.matmul(qf, vectors[lo:hi].float().T)   # exact widening
        return _sweep_distance(dots, q_sq, v_sq[lo:hi][None, :], metric)

    return _sweep_plain(dist_tile, vectors.shape[0], queries.shape[0], int(n),
                        k, nt, vectors.device)


def int8_sweep_topk_plain(v8, vscale, v_sq, q8, qmeta, n, *, k: int,
                          metric: Metric, nt: int = DEFAULT_NT):
    """Plain version of the int8 sweep: dots_i32 * qscale * vscale (in that
    order) through the metric formula, with |q|^2 = qmeta[:, 1]."""
    metric = Metric.coerce(metric)
    qf = q8.float()
    qs = qmeta[:, 0:1]
    q_sq = qmeta[:, 1:2]

    def dist_tile(lo, hi):
        dots = torch.matmul(qf, v8[lo:hi].float().T)        # exact int dots
        dotsf = dots * qs * vscale[lo:hi][None, :]
        return _sweep_distance(dotsf, q_sq, v_sq[lo:hi][None, :], metric)

    return _sweep_plain(dist_tile, v8.shape[0], q8.shape[0], int(n), k, nt,
                        v8.device)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

# tiles a split may hold: the bank kernels (bf16 and int8) keep a kept row
# as its 16-bit tile index within the split, 0xFFFF meaning none
MAX_SPLIT_TILES = 0xFFFF


def split_plan(qblocks: int, ntiles: int, sms: int) -> int:
    """Corpus splits per query block: the count that fills `sms` SMs in the
    most even number of waves (one block per SM at a time), raised where
    needed so that no split holds more than MAX_SPLIT_TILES tiles."""
    best, best_eff = 1, 0.0
    for s in range(1, min(ntiles, 16) + 1):
        waves = qblocks * s / sms
        eff = waves / math.ceil(waves)
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
    return max(best, -(-ntiles // MAX_SPLIT_TILES))


# partial lists a query may have in the sweep kernels' merge (csrc/sweep.cu,
# kMaxLists)
SWEEP_MAX_LISTS = 32


def sweep_plan(qblocks: int, ntiles: int, sms: int) -> tuple:
    """(corpus splits, partial lists per query) of the sweep kernels:
    split_plan's splits, at most SWEEP_MAX_LISTS // 2 (a sweep keeps whole
    row numbers, so the banks' tile cap does not bind it), and two lists a
    split, since each of a block's two consumer warpgroups keeps its own
    lists over the tiles it takes (every other tile of the split)."""
    splits = min(split_plan(qblocks, ntiles, sms), SWEEP_MAX_LISTS // 2)
    return splits, 2 * splits


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(qblocks: int, ntiles: int, device) -> int:
    return split_plan(qblocks, ntiles, _sms(device))


def _check_tensors(dev, tensors, f32):
    for t in tensors:
        _cuda.require(t.is_cuda and t.device == dev,
                      "all tensors must be on one CUDA device")
        _cuda.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      "tensors must be contiguous and 16-byte aligned")
    for t in f32:
        _cuda.require(t.dtype == torch.float32, "scales/keys must be float32")


def _check_scan(vectors, queries, dtype):
    n_pad, d = vectors.shape
    _cuda.require(vectors.dtype == dtype and queries.dtype == dtype,
                  f"vectors and queries must be {dtype}")
    _cuda.require(queries.ndim == 2 and queries.shape[1] == d,
                  f"queries must be [B, {d}]")
    _cuda.require(n_pad % KPAD == 0, "N_pad must be a multiple of 128")
    _cuda.require((d * vectors.element_size()) % 128 == 0,
                  "rows must be a multiple of 128 bytes")
    return n_pad, d, queries.shape[0]


def _launch_bank(kind: str, vectors, vkey, queries, n, metric=None,
                 vscale=None, qscale=None, nt: int = INT8_NT):
    """kind "bf16" / "int8": the bucketed banks; "packed": the packed int8
    bank over nt-row tiles (vkey is then nvkey)."""
    dev = vectors.device
    int8 = kind != "bf16"
    n_pad, d, b = _check_scan(vectors, queries,
                              torch.int8 if int8 else torch.bfloat16)
    extra = [vscale, qscale] if kind == "int8" else []
    _check_tensors(dev, [vectors, vkey, queries] + extra, [vkey] + extra)
    _cuda.require(vkey.shape == (n_pad,), "vkey must be [N_pad]")
    if kind == "int8":
        _cuda.require(vscale.shape == (n_pad,) and qscale.shape == (b,),
                      "vscale must be [N_pad] and qscale [B]")
    if kind == "packed":
        _cuda.require(nt % KPAD == 0 and n_pad % nt == 0,
                      "N_pad must be a multiple of nt, nt of 128")
        group, gbits = _group_bits(nt)
        units = n_pad // nt
    else:
        units = n_pad // KPAD
    splits = _splits(-(-b // 64), units, dev)
    part_d = torch.empty((splits, b, 2 * KPAD), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, b, 2 * KPAD), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, 2 * KPAD), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, 2 * KPAD), dtype=torch.int32, device=dev)
    lib = _cuda.library("scan.cu")
    stream = _cuda.stream_ptr(dev)
    if kind == "packed":
        code = lib.packed_bank_int8(
            vectors.data_ptr(), vkey.data_ptr(), queries.data_ptr(),
            part_d.data_ptr(), part_r.data_ptr(), b, n_pad, d, int(n), group,
            gbits, splits, stream)
        name, counter = "int8_packed_topk", int8_packed_topk
    elif int8:
        code = lib.bucket_bank_int8(
            vectors.data_ptr(), vkey.data_ptr(), vscale.data_ptr(),
            queries.data_ptr(), qscale.data_ptr(), part_d.data_ptr(),
            part_r.data_ptr(), b, n_pad, d, int(n), _METRIC_CODE[metric],
            splits, stream)
        name, counter = "int8_bucket_topk", int8_bucket_topk
    else:
        code = lib.bucket_bank_bf16(
            vectors.data_ptr(), vkey.data_ptr(), queries.data_ptr(),
            part_d.data_ptr(), part_r.data_ptr(), b, n_pad, d, int(n),
            _METRIC_CODE[metric], splits, stream)
        name, counter = "bucket_topk", bucket_topk
    _cuda.check(code, name)
    code = lib.bucket_merge(part_d.data_ptr(), part_r.data_ptr(),
                            out_d.data_ptr(), out_r.data_ptr(), b, splits,
                            stream)
    _cuda.check(code, "bucket_merge")
    counter.launches += 1
    return out_d, out_r


def _launch_sweep(int8: bool, vectors, v_sq, queries, n, k: int, metric,
                  vscale=None, qmeta=None):
    dev = vectors.device
    n_pad, d, b = _check_scan(vectors, queries,
                              torch.int8 if int8 else torch.bfloat16)
    extra = [vscale, qmeta] if int8 else []
    _check_tensors(dev, [vectors, v_sq, queries] + extra, [v_sq] + extra)
    _cuda.require(v_sq.shape == (n_pad,), "v_sq must be [N_pad]")
    if int8:
        _cuda.require(vscale.shape == (n_pad,) and qmeta.shape == (b, 2),
                      "vscale must be [N_pad] and qmeta [B, 2]")
    _cuda.require(supported(k), "the sweep kernels take 1 <= k <= 32")
    splits, lists = sweep_plan(-(-b // 64), n_pad // KPAD, _sms(dev))
    part_d = torch.empty((lists, b, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((lists, b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _cuda.library("sweep.cu")
    stream = _cuda.stream_ptr(dev)
    if int8:
        code = lib.sweep_topk_int8(
            vectors.data_ptr(), v_sq.data_ptr(), vscale.data_ptr(),
            queries.data_ptr(), qmeta.data_ptr(), part_d.data_ptr(),
            part_r.data_ptr(), b, n_pad, d, int(n), k, _METRIC_CODE[metric],
            splits, stream)
        name, counter = "int8_sweep_topk", int8_sweep_topk
    else:
        code = lib.sweep_topk_bf16(
            vectors.data_ptr(), v_sq.data_ptr(), queries.data_ptr(),
            part_d.data_ptr(), part_r.data_ptr(), b, n_pad, d, int(n), k,
            _METRIC_CODE[metric], splits, stream)
        name, counter = "exact_topk_sweep", exact_topk_sweep
    _cuda.check(code, name)
    code = lib.sweep_merge(part_d.data_ptr(), part_r.data_ptr(),
                           out_d.data_ptr(), out_r.data_ptr(), b, k, lists,
                           stream)
    _cuda.check(code, "sweep_merge")
    counter.launches += 1
    return out_d, out_r


def bucket_bank(vectors, vkey, queries, n, *, metric: Metric,
                nt: int = DEFAULT_NT):
    """The bf16 best-two bank [B, 256] (keys, rows): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    metric = Metric.coerce(metric)
    if vectors.device.type == "cpu":
        return bucket_bank_plain(vectors, vkey, queries, n, metric=metric,
                                 nt=nt)
    return _launch_bank("bf16", vectors, vkey, queries, n, metric)


def int8_bucket_bank(v8, vkey, vscale, q8, qscale, n, *, metric: Metric,
                     nt: int = INT8_NT):
    """The int8 best-two bank [B, 256] (keys, rows)."""
    metric = Metric.coerce(metric)
    if v8.device.type == "cpu":
        return int8_bucket_bank_plain(v8, vkey, vscale, q8, qscale, n,
                                      metric=metric, nt=nt)
    return _launch_bank("int8", v8, vkey, q8, n, metric, vscale=vscale,
                        qscale=qscale)


def int8_packed_bank(v8, nvkey, q8, n, *, nt: int = INT8_NT):
    """The packed int8 bank [B, 256] (biased keys, rows)."""
    if v8.device.type == "cpu":
        return int8_packed_bank_plain(v8, nvkey, q8, n, nt=nt)
    return _launch_bank("packed", v8, nvkey, q8, n, nt=nt)


def bf16_vkey(v_sq, metric: Metric):
    metric = Metric.coerce(metric)
    if metric == Metric.COSINE:
        return 1.0 / torch.sqrt(torch.clamp(v_sq, min=1e-12))
    if metric == Metric.EUCLIDEAN:
        return v_sq
    return torch.zeros_like(v_sq)


def int8_vkey(vscale, v_sq, metric: Metric):
    metric = Metric.coerce(metric)
    if metric == Metric.COSINE:
        return vscale / torch.sqrt(torch.clamp(v_sq, min=1e-12))
    if metric == Metric.EUCLIDEAN:
        return v_sq
    return vscale


def _bank_topk(bank_d, bank_r, k: int):
    kk = min(k, bank_d.shape[-1])
    dk, sel = top_k_ascending(bank_d, kk)
    return dk, torch.gather(bank_r, -1, sel)


def _pad_k(d, r, k: int):
    if d.shape[-1] < k:
        pad = k - d.shape[-1]
        d = torch.nn.functional.pad(d, (0, pad), value=BIG)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    return d, r


def bucket_topk(vectors, v_sq, queries, n, *, k: int, metric: Metric,
                bt: int = DEFAULT_BT, nt: int = DEFAULT_NT):
    """Bucketed fused bf16 scan (``pallas_bucket_topk``).

    vectors [N_pad, D] bf16 (N_pad % nt == 0), v_sq [N_pad] f32, queries
    [B, D] bf16 (B % bt == 0), n valid rows. Returns (dists f32 [B, k],
    rows int32 [B, k]); top-k is exact up to 3-way bucket collisions."""
    metric = Metric.coerce(metric)
    _check_contract(vectors.shape[0], nt, queries.shape[0], bt)
    bank_d, bank_r = bucket_bank(vectors, bf16_vkey(v_sq, metric), queries, n,
                                 metric=metric, nt=nt)
    dk, rk = _bank_topk(bank_d, bank_r, k)
    q_sq = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
    if metric == Metric.COSINE:
        dist = 1.0 + dk / torch.sqrt(torch.clamp(q_sq, min=1e-12))
    elif metric == Metric.EUCLIDEAN:
        dist = torch.sqrt(torch.clamp(dk + q_sq, min=0.0))
    else:
        dist = dk
    ok = (dk < BIG) & (rk >= 0)
    dist = torch.where(ok, dist, BIG)
    rk = torch.where(ok, rk, -1)
    return _pad_k(dist, rk, k)


def int8_bucket_topk(v8, vscale, v_sq, q8, qmeta, n, *, k: int,
                     metric: Metric, bt: int = DEFAULT_BT,
                     nt: int = DEFAULT_NT):
    """Bucketed quantized coarse scan (``pallas_int8_bucket_topk``).

    v8 [N_pad, D] int8, vscale / v_sq [N_pad] f32, q8 [B, D] int8,
    qmeta [B, 2] f32 (dequant scale, exact |q|^2). Returns (coarse keys
    [B, k], candidate rows int32 [B, k]); callers re-rank or rebuild
    distances from the keys."""
    metric = Metric.coerce(metric)
    _check_contract(v8.shape[0], nt, q8.shape[0], bt)
    qscale = qmeta[:, 0].contiguous()
    bank_d, bank_r = int8_bucket_bank(v8, int8_vkey(vscale, v_sq, metric),
                                      vscale, q8, qscale, n, metric=metric,
                                      nt=nt)
    dk, rk = _bank_topk(bank_d, bank_r, k)
    rk = torch.where((dk < BIG) & (rk >= 0), rk, -1)
    return _pad_k(dk, rk, k)


def _check_contract(n_pad: int, nt: int, b: int, bt: int):
    if n_pad % nt or b % bt:
        raise ValueError(f"need n_pad % nt == 0 and b % bt == 0, got "
                         f"{(n_pad, nt, b, bt)}")


def int8_packed_topk(v8, vscale, v_sq, q8, qmeta, n, *, k: int,
                     metric: Metric, bt: int = INT8_BT, nt: int = INT8_NT):
    """Packed-key bucketed int8 coarse scan (``pallas_int8_packed_topk``),
    cosine and dot only. Returns (un-biased keys [B, k], with the bucket
    kernel's key semantics, and candidate rows int32 [B, k])."""
    metric = Metric.coerce(metric)
    if metric not in (Metric.COSINE, Metric.DOT):
        raise ValueError(f"the packed scan serves cosine and dot, not {metric}")
    _check_contract(v8.shape[0], nt, q8.shape[0], bt)
    if metric == Metric.COSINE:
        nvkey = -vscale / torch.sqrt(torch.clamp(v_sq, min=1e-12))
    else:
        nvkey = -vscale
    bank_d, bank_r = int8_packed_bank(v8, nvkey.contiguous(), q8, n, nt=nt)
    dk, rk = _bank_topk(bank_d, bank_r, k)
    ok = (dk < BIG) & (rk >= 0)
    dk = torch.where(ok, dk - PACK_BIAS, BIG)     # un-bias: raw monotone key
    rk = torch.where(ok, rk, -1)
    return _pad_k(dk, rk, k)


def exact_topk_sweep(vectors, v_sq, queries, n, *, k: int, metric: Metric,
                     bt: int = DEFAULT_BT, nt: int = DEFAULT_NT):
    """Fused bf16 scan with an exact running top-k (``pallas_exact_topk``).

    vectors [N_pad, D] bf16 (N_pad % nt == 0), v_sq [N_pad] f32, queries
    [B, D] bf16 (B % bt == 0), n valid rows. Returns (dists f32 [B, k],
    rows int32 [B, k]), rows -1 and dists BIG past the valid rows."""
    metric = Metric.coerce(metric)
    _check_contract(vectors.shape[0], nt, queries.shape[0], bt)
    if vectors.device.type == "cpu":
        return exact_topk_sweep_plain(vectors, v_sq, queries, n, k=k,
                                      metric=metric, nt=nt)
    return _launch_sweep(False, vectors, v_sq, queries, n, k, metric)


def int8_sweep_topk(v8, vscale, v_sq, q8, qmeta, n, *, k: int,
                    metric: Metric, bt: int = DEFAULT_BT,
                    nt: int = DEFAULT_NT):
    """Quantized fused scan with an exact running top-k
    (``pallas_int8_topk``): approximate (dists [B, k], rows [B, k]) from
    dequantized int8 dots; callers re-rank with exact f32 scores."""
    metric = Metric.coerce(metric)
    _check_contract(v8.shape[0], nt, q8.shape[0], bt)
    if v8.device.type == "cpu":
        return int8_sweep_topk_plain(v8, vscale, v_sq, q8, qmeta, n, k=k,
                                     metric=metric, nt=nt)
    return _launch_sweep(True, v8, v_sq, q8, n, k, metric, vscale=vscale,
                         qmeta=qmeta)


# launch counts: incremented where a kernel is launched, nowhere else
bucket_topk.launches = 0
int8_bucket_topk.launches = 0
int8_packed_topk.launches = 0
exact_topk_sweep.launches = 0
int8_sweep_topk.launches = 0

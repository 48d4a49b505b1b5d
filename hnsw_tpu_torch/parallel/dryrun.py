"""One sharded step of every multi-device path on tiny shapes: the twin of
``__graft_entry__.dryrun_multichip``, on make_mesh(n_devices,
device=device): the CUDA cards by default, or n virtual entries of another
device."""

from __future__ import annotations

import numpy as np
import torch


def _tiny_data(n=512, dim=64, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _self_first(rows, what: str) -> None:
    if int(rows[0, 0]) != 0:
        raise RuntimeError(f"{what}: self row not found")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """On an n-device mesh, run once each: (1) the sharded Lloyd step,
    (2) the partition-sharded HNSW search, (3) the row-sharded exact
    search, (4) the sharded build and a sharded search of it, (5) the
    cluster-sharded IVF scan. Raises when a step fails or a query's own
    row is not its first result."""
    from hnsw_tpu_torch.models import (build_flat_index,
                                       build_ivf_flat_index,
                                       build_partitioned_hnsw)
    from hnsw_tpu_torch.parallel import (ShardedFlatIndex, ShardedIVFFlat,
                                         ShardedPartitionedHNSW,
                                         build_partitioned_hnsw_sharded,
                                         make_mesh)
    from hnsw_tpu_torch.parallel.sharded import sharded_lloyd_step

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.first
    data = _tiny_data(32 * n_devices, 64)

    # (1) the sharded k-means step
    flat = build_flat_index(data, device=dev)
    c = flat.corpus
    grow = -c.n_pad % n_devices
    vecs = torch.nn.functional.pad(c.vectors, (0, 0, 0, grow))
    v_sq = torch.nn.functional.pad(c.sq_norms, (0, grow))
    valid = (torch.arange(vecs.shape[0], device=dev) < c.n).float()
    cents, _ = sharded_lloyd_step(mesh, vecs, v_sq, valid, c.vectors[:8],
                                  metric=c.metric)
    if not bool(torch.isfinite(cents).all()):
        raise RuntimeError("sharded Lloyd step: non-finite centroids")

    # (2) the partition-sharded HNSW search
    pidx = build_partitioned_hnsw(data, num_partitions=n_devices, M=4,
                                  device=dev)
    _, r = ShardedPartitionedHNSW(pidx, mesh).search_batch(
        data[:8], 5, mode="precise")
    _self_first(r, "partition-sharded search")

    # (3) the row-sharded exact search
    _, r = ShardedFlatIndex(c, mesh).search_batch(data[:8], 5)
    _self_first(r, "row-sharded exact search")

    # (4) the sharded build, searched sharded
    bidx = build_partitioned_hnsw_sharded(data, num_partitions=n_devices,
                                          mesh=mesh, M=4)
    _, r = ShardedPartitionedHNSW(bidx, mesh).search_batch(
        data[:8], 5, mode="precise")
    _self_first(r, "sharded build")

    # (5) the cluster-sharded IVF scan
    ivf = build_ivf_flat_index(data, num_partitions=2 * n_devices, spill=1,
                               device=dev)
    _, r = ShardedIVFFlat(ivf, mesh).search_batch(data[:8], 5,
                                                  mode="precise")
    _self_first(r, "cluster-sharded IVF")


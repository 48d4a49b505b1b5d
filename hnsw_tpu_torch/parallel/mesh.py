"""The device mesh and its two collectives. Counterpart of
``hnsw_tpu/parallel/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` driven by one process under
``shard_map``. Here one Python process drives an ordered array of
``torch.device`` entries the same way: a sharded tensor is a list of
per-device pieces in mesh order, a collective copies the pieces to the
mesh's first device, and a "replicated" result is a tensor on that first
device. Entries may repeat: a mesh of four ``cuda:0`` entries
(``make_mesh(4, device="cuda:0")``), or of eight ``cpu`` entries (the
port's form of ``jax_num_cpu_devices``), runs the whole
split / per-shard work / gather on one device, with the shards sharing its
stream. CUDA launches return before the work ends, so a loop over distinct
cards keeps each of them busy at once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hnsw_tpu_torch.types import resolve_device


class Mesh:
    """An array of torch.device entries with one name per axis."""

    def __init__(self, devices: Sequence, axis_names=("shards",)):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        arr.flat[:] = [torch.device(d) for d in src.flat]
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array with axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        """The entries in mesh order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    @property
    def first(self) -> torch.device:
        """Where collectives land and sharded calls return."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


def device_count() -> int:
    """CUDA devices of this process."""
    return torch.cuda.device_count()


def _entries(n: Optional[int], device) -> List[torch.device]:
    """n entries of `device`, resolved as types.resolve_device does. The
    CUDA card type with no index ("cuda", or None) lists the cards
    cuda:0..n-1, at most torch.cuda.device_count() of them (default: all);
    one named device ("cuda:0", "cpu") gives n virtual entries of itself
    (default: one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        n = n or have
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * (n or 1)


def make_mesh(n_devices: Optional[int] = None, axis: str = "shards", *,
              device=None) -> Mesh:
    """1-D mesh over the first n CUDA cards (default: all), or over n
    virtual entries of one named device (see _entries). The single axis
    carries the corpus or partition shard dimension; queries stay
    replicated."""
    return Mesh(_entries(n_devices, device), axis_names=(axis,))


def make_mesh_2d(n_shard: int, n_data: int, shard_axis: str = "shards",
                 data_axis: str = "data", *, device=None) -> Mesh:
    """2-D mesh: partition axis x query-data axis."""
    devs = np.asarray(_entries(n_shard * n_data, device), dtype=object)
    return Mesh(devs.reshape(n_shard, n_data),
                axis_names=(shard_axis, data_axis))


def shard(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Split dim 0 evenly over the mesh, piece i on entry i. A dim 0 the
    mesh does not divide raises, as a NamedSharding would. A piece on the
    device it already lies on is a view."""
    d = mesh.size
    if x.shape[0] % d:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not divide over "
                         f"{d} devices")
    return [p.to(dev) for p, dev in zip(torch.chunk(x, d), mesh.device_list)]


def as_shards(mesh: Mesh, x) -> List[torch.Tensor]:
    """x as its per-device pieces: a list of mesh.size pieces passes as it
    is; a tensor is split with shard()."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return list(x)
    return shard(mesh, x)


def all_gather(mesh: Mesh, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each shard's tensor copied to the mesh's first device and stacked in
    mesh order: [mesh.size, ...]."""
    return torch.stack([p.to(mesh.first) for p in pieces])


def psum(mesh: Mesh, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every shard's tensor, in mesh order, on the first
    device."""
    out = pieces[0].to(mesh.first)
    for p in pieces[1:]:
        out = out + p.to(mesh.first)
    return out

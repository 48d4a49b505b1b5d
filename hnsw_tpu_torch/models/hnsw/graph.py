"""HNSW graph structure: flat, fixed-degree int32 adjacency tables.
Counterpart of ``hnsw_tpu/models/hnsw/graph.py``.

  levels    int32[N_pad]          per-node top level (-1 for padding rows)
  adj0      int32[N_pad, M0]      layer-0 neighbors, -1 = empty slot
  adj_upper int32[L, N_pad, M]    layers 1..L, -1 = empty slot
  entry     int                   entry point node id

Degree caps M0 = 2M at layer 0 and M above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NONE = -1  # empty adjacency slot / no node


@dataclasses.dataclass
class HNSWGraph:
    levels: torch.Tensor      # int32 [N_pad]
    adj0: torch.Tensor        # int32 [N_pad, M0]
    adj_upper: torch.Tensor   # int32 [L, N_pad, M]  (L may be 0)
    entry: int                # entry node id (host int; -1 if empty)
    max_level: int            # top layer index (0 = flat graph)
    m: int                    # M (upper-layer degree cap)
    m0: int                   # layer-0 degree cap (2M)
    ef_construction: int
    n: int                    # real node count
    n_bridges: int = 0        # connectivity-repair edges added (repair.py)

    @property
    def n_pad(self) -> int:
        return int(self.adj0.shape[0])

    def info(self) -> dict:
        """Graph stats."""
        adj0 = self.adj0[: self.n].cpu().numpy()
        deg = (adj0 >= 0).sum(axis=1)
        levels = self.levels[: self.n].cpu().numpy()
        return {
            "element_count": self.n,
            "entry_point": int(self.entry),
            "max_level": int(self.max_level),
            "M": self.m,
            "M0": self.m0,
            "ef_construction": self.ef_construction,
            "avg_connections_l0": float(deg.mean()) if self.n else 0.0,
            "bridge_edges": int(self.n_bridges),
            "level_histogram": {int(l): int(c) for l, c in
                                zip(*np.unique(levels, return_counts=True))},
        }


def assign_levels(n: int, ml: float, seed: int, max_cap: int = 16) -> np.ndarray:
    """Seeded exponential level assignment: floor(ml * -ln u), from the same
    numpy generator as the JAX package, so the same seed gives the same
    levels."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    lv = np.floor(-np.log(np.maximum(u, 1e-12)) * ml).astype(np.int32)
    return np.minimum(lv, max_cap)


def empty_graph(n_pad: int, m: int, m0: int, max_level: int,
                ef_construction: int, device=None) -> HNSWGraph:
    lu = max(max_level, 0)
    return HNSWGraph(
        levels=torch.full((n_pad,), NONE, dtype=torch.int32, device=device),
        adj0=torch.full((n_pad, m0), NONE, dtype=torch.int32, device=device),
        adj_upper=torch.full((lu, n_pad, m), NONE, dtype=torch.int32,
                             device=device),
        entry=NONE,
        max_level=0,
        m=m, m0=m0,
        ef_construction=ef_construction,
        n=0,
    )

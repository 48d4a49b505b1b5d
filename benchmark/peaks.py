"""The yardstick's peaks and byte counts, frozen here so that a later change
to the program cannot move them.

``HBM_BYTES_S`` is the HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet,
at the full 700 W power limit). ``hop_bytes`` is a copy of
``hnsw_tpu_torch/bench/kernels.py:hop_bytes``: what one launch of the hop
kernel B1 must move, each distinct selected neighbour block read once.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12


def hop_bytes(pack, queries, sel, outs: int) -> int:
    """Bytes one hop must move: each distinct selected block once, the
    queries, the rows and `outs` f32 outputs of [B, E*M0]."""
    _, m0, d = pack.shape
    b, e = sel.shape
    uniq = int(torch.unique(torch.clamp(sel, min=0)).numel())
    return (uniq * m0 * d * pack.element_size() + b * d * 4 + b * e * 4
            + outs * b * e * m0 * 4)

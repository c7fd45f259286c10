"""Blocked kd-tree (the paper's §2.2.2 / §5.2, adapted to blocked visits).

Ports ``repro/core/kdtree.py``; the build is the reference's numpy code line
for line, so both packages permute objects identically.

Build: recursive median splits with round-robin delimiter dimensions — the
original Bentley policy the paper also uses — but splitting stops at *leaf
blocks* of ``tile_n`` objects instead of single objects: a block is what one
visit of the phase-2 kernel scans.

Query: the shared two-phase plan from ``blockindex`` (vectorized hierarchy
prune -> visit kernel over surviving leaves). The hierarchy prune over
axis-aligned block boxes is exactly the kd-tree interval-overlap descent,
evaluated breadth-first over all nodes of a level at once.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types as T
from repro_torch.core.blockindex import BlockedIndex, finish_build


def _median_split(
    cols: np.ndarray, idx: np.ndarray, depth: int, tile_n: int, order: list[np.ndarray]
) -> None:
    """Recursively split ``idx`` (ids into cols) until <= tile_n, in-order."""
    if idx.size <= tile_n:
        order.append(idx)
        return
    dim = depth % cols.shape[0]  # round-robin delimiter dimension (paper §2.2.2)
    vals = cols[dim, idx]
    half = idx.size // 2
    part = np.argpartition(vals, half)
    _median_split(cols, idx[part[:half]], depth + 1, tile_n, order)
    _median_split(cols, idx[part[half:]], depth + 1, tile_n, order)


def build_kdtree(
    dataset: T.Dataset, tile_n: int = 1024, fanout: int = 64, *,
    device, backend: str = "auto"
) -> BlockedIndex:
    """Build a blocked kd-tree over the dataset, on ``device``.

    Args:
      dataset: columnar dataset.
      tile_n: leaf block size (objects).
      fanout: MBR hierarchy fanout for the prune phase.
    """
    cols = dataset.cols
    order: list[np.ndarray] = []
    _median_split(cols, np.arange(dataset.n), 0, tile_n, order)
    perm = np.concatenate(order)
    cols_perm = cols[:, perm]
    return finish_build("kdtree", cols_perm, perm, tile_n, fanout,
                        device=device, backend=backend)

"""Packed STR R*-tree (the paper's §2.2.1 / §5.1, bulk-loaded).

Ports ``repro/core/rstar.py``; the build is the reference's numpy code line
for line, so both packages permute objects identically.

The paper uses libspatialindex's R*-tree with insert-time re-insertion
splits. For the analytical workloads the paper targets (bulk loads, rare
updates), the equivalent is a *bulk-loaded packed* R-tree:
Sort-Tile-Recursive (STR, Leutenegger et al. 1997) tiles the space so leaf
MBRs are near-minimal-overlap — the objective the R*-tree's re-insertion
heuristic optimizes incrementally — and the structure is a dense,
pointer-free array of MBRs pruned breadth-first. Leaf capacity = ``tile_n``
objects, one visit of the phase-2 kernel.

Query: the shared two-phase plan (see ``blockindex``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types as T
from repro_torch.core.blockindex import BlockedIndex, finish_build


def _str_order(cols: np.ndarray, idx: np.ndarray, dims: list[int], tile_n: int) -> list[np.ndarray]:
    """Sort-Tile-Recursive: sort by dims[0], slice, recurse within slices."""
    if idx.size <= tile_n or not dims:
        return [idx]
    d = dims[0]
    srt = idx[np.argsort(cols[d, idx], kind="stable")]
    # Number of slabs: objects-per-slab such that remaining dims can tile into
    # tile_n leaves — the standard STR S = ceil((n/tile_n)^(1/k)) slab count.
    n_leaves = -(-idx.size // tile_n)
    slabs = int(np.ceil(n_leaves ** (1.0 / len(dims))))
    slab_size = -(-idx.size // slabs)
    out: list[np.ndarray] = []
    for s in range(slabs):
        part = srt[s * slab_size : (s + 1) * slab_size]
        if part.size:
            out.extend(_str_order(cols, part, dims[1:], tile_n))
    return out


def build_rstar(
    dataset: T.Dataset, tile_n: int = 1024, fanout: int = 64,
    sort_dims: int | None = None, *, device, backend: str = "auto"
) -> BlockedIndex:
    """Bulk-load a packed STR R-tree, on ``device``.

    Args:
      dataset: columnar dataset.
      tile_n: leaf capacity (objects per MBR leaf).
      fanout: inner-level fanout.
      sort_dims: how many leading dimensions STR sorts by (default: all, capped
        at 6 — beyond that the per-dim slab count degenerates to 1).
    """
    cols = dataset.cols
    k = min(dataset.m, 6 if sort_dims is None else sort_dims)
    order = _str_order(cols, np.arange(dataset.n), list(range(k)), tile_n)
    perm = np.concatenate(order)
    cols_perm = cols[:, perm]
    return finish_build("rstar", cols_perm, perm, tile_n, fanout,
                        device=device, backend=backend)

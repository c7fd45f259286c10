"""Synthetic datasets and workloads from the paper's evaluation (§7.2, Table 2).

  * SYNT-UNI   — uniform in [0,1]^m, 10k..10M objects, 5..100 dims.
  * SYNT-CLUST — 1..20 uniform clusters in subspace boxes (Müller et al. [29]
    generator, re-implemented: cluster centers uniform, per-cluster box with
    side ~10% of the domain, points uniform inside their cluster's box).

Copies of the reference package's generators: the same seed gives the same
dataset in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types as T


def synt_uni(n: int, m: int, seed: int = 0) -> T.Dataset:
    rng = np.random.default_rng(seed)
    return T.Dataset(rng.random((m, n), dtype=np.float32))


def synt_clust(n: int, m: int, n_clusters: int, seed: int = 0,
               cluster_side: float = 0.1) -> T.Dataset:
    """Clustered data: uniform inside per-cluster boxes (paper §7.2.2)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n_clusters, m))
    assign = rng.integers(0, n_clusters, size=n)
    lo = np.clip(centers[assign] - cluster_side / 2, 0.0, 1.0 - cluster_side)
    pts = lo + rng.random((n, m)) * cluster_side
    return T.Dataset(pts.astype(np.float32).T)


def random_pair_query(dataset: T.Dataset, rng: np.random.Generator) -> T.RangeQuery:
    """The paper's query generator: bounds from two random objects (§7.2.1)."""
    i, j = rng.integers(dataset.n), rng.integers(dataset.n)
    a, b = dataset.cols[:, i], dataset.cols[:, j]
    return T.RangeQuery.complete(np.minimum(a, b), np.maximum(a, b))


def workload(dataset: T.Dataset, n_queries: int, seed: int = 0) -> list[T.RangeQuery]:
    rng = np.random.default_rng(seed)
    return [random_pair_query(dataset, rng) for _ in range(n_queries)]

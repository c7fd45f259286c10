"""GMRQB — the Genomic Multidimensional Range Query Benchmark (paper §6).

The paper's benchmark: 10M genomic variation records with 19 attributes
derived from the 1000 Genomes Project, plus eight parameterized query
templates whose average selectivities span 10.76% down to 1e-7 (Table 1).

The original dataset is a 724 MB download that is not redistributable, so
``build`` synthesizes a *shape-faithful* stand-in:
every attribute reproduces the published domain/cardinality structure
(chromosome 1–23, location up to 2.5e8 with variation-rich/poor regions,
hashed categoricals for population/family/sample, skewed quality/depth, beta-
distributed allele frequencies, …). Template instantiation follows §6.2: all
templates constrain the genomic position (chromosome + location); higher
templates add attributes until template 8 is a 19-dim complete-match query.
Achieved selectivities are measured, not assumed.

A copy of the reference package's generator: the same seed gives the same
dataset and the same queries in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types as T

ATTRS = [
    "chromosome",        # 0: 1..23
    "location",          # 1: 0..2.5e8, clustered (variation-rich regions)
    "quality",           # 2: 0..100 skewed high
    "depth",             # 3: 1..5000 log-normal-ish
    "reference_genome",  # 4: 3 distinct
    "variation_id",      # 5: ~unique
    "allele_freq",       # 6: beta(0.2, 2) in [0,1]
    "allele_count",      # 7: 1..5008
    "ref_base",          # 8: 4 distinct
    "alt_base",          # 9: 4 distinct
    "ancestral_allele",  # 10: 5 distinct
    "variant_type",      # 11: 6 distinct
    "sample_id",         # 12: 2504 distinct
    "gender",            # 13: 2 distinct
    "family_id",         # 14: ~1800 distinct
    "population",        # 15: 26 distinct
    "relationship",      # 16: 9 distinct
    "genotype",          # 17: 3 distinct
    "age",               # 18: 1..90 (patient metadata; §1 genomics use case)
]
M = len(ATTRS)
LOC_MAX = 2.5e8


def build(n: int, seed: int = 0) -> T.Dataset:
    rng = np.random.default_rng(seed)
    cols = np.empty((M, n), dtype=np.float32)
    cols[0] = rng.integers(1, 24, size=n)
    # variation-rich regions: mixture of uniform background + dense hotspots
    hot = rng.random(n) < 0.6
    centers = rng.choice(np.linspace(0.05, 0.95, 40), size=n) * LOC_MAX
    cols[1] = np.where(
        hot,
        np.clip(centers + rng.normal(0, LOC_MAX * 0.004, size=n), 0, LOC_MAX),
        rng.random(n) * LOC_MAX,
    )
    cols[2] = 100.0 * rng.beta(5.0, 1.5, size=n)
    cols[3] = np.minimum(5000, np.exp(rng.normal(3.5, 1.0, size=n))).astype(np.float32)
    cols[4] = rng.integers(0, 3, size=n)
    cols[5] = rng.permutation(n).astype(np.float32)
    cols[6] = rng.beta(0.2, 2.0, size=n)
    cols[7] = np.ceil(cols[6] * 5008.0) + 1.0
    cols[8] = rng.integers(0, 4, size=n)
    cols[9] = rng.integers(0, 4, size=n)
    cols[10] = rng.integers(0, 5, size=n)
    cols[11] = rng.integers(0, 6, size=n)
    cols[12] = rng.integers(0, 2504, size=n)
    cols[13] = rng.integers(0, 2, size=n)
    cols[14] = (cols[12] // 1.4).astype(np.float32)  # families group samples
    cols[15] = (cols[12] % 26).astype(np.float32)    # population from sample
    cols[16] = rng.integers(0, 9, size=n)
    cols[17] = rng.integers(0, 3, size=n)
    cols[18] = np.clip(rng.normal(45, 18, size=n), 1, 90)
    return T.Dataset(cols)


def _loc_range(rng: np.random.Generator, frac: float) -> tuple[float, float]:
    width = frac * LOC_MAX
    start = rng.random() * (LOC_MAX - width)
    return (start, start + width)


def template(k: int, rng: np.random.Generator, dataset: T.Dataset | None = None) -> T.RangeQuery:
    """Instantiate GMRQB query template k (1..8), paper §6.2 / Table 1.

    All templates constrain chromosome + location; higher templates add
    attributes. Template 8 is the complete-match query over all 19 dims
    (instantiated around a random record, selectivity ~ 1/n like the paper's
    1e-7).
    """
    chrom = float(rng.integers(1, 24))
    if k == 1:      # 2 dims, ~10%
        lo, hi = _loc_range(rng, 0.40)
        return T.RangeQuery.partial(M, {0: (chrom, min(23.0, chrom + 5)), 1: (lo, hi)})
    if k == 2:      # 5 dims, ~2%
        lo, hi = _loc_range(rng, 0.45)
        return T.RangeQuery.partial(M, {
            0: (chrom, min(23.0, chrom + 4)), 1: (lo, hi),
            2: (10.0, 100.0), 3: (10.0, 1000.0), 6: (0.03, 1.0),
        })
    if k == 3:      # 3 dims, ~5%
        lo, hi = _loc_range(rng, 0.35)
        return T.RangeQuery.partial(M, {
            0: (chrom, min(23.0, chrom + 4)), 1: (lo, hi), 2: (40.0, 100.0),
        })
    if k == 4:      # 4 dims, ~0.2%
        lo, hi = _loc_range(rng, 0.15)
        return T.RangeQuery.partial(M, {
            0: (chrom, chrom), 1: (lo, hi), 3: (10.0, 1000.0), 6: (0.05, 0.9),
        })
    if k == 5:      # 5 dims, ~0.2%
        lo, hi = _loc_range(rng, 0.25)
        return T.RangeQuery.partial(M, {
            0: (chrom, chrom), 1: (lo, hi), 2: (20.0, 95.0),
            13: (0.0, 0.0), 6: (0.01, 0.8),
        })
    if k == 6:      # 6 dims, ~0.1%
        lo, hi = _loc_range(rng, 0.3)
        pop = float(rng.integers(0, 26))
        return T.RangeQuery.partial(M, {
            0: (chrom, chrom), 1: (lo, hi), 2: (10.0, 100.0),
            15: (pop, pop + 3), 3: (5.0, 2000.0), 18: (20.0, 70.0),
        })
    if k == 7:      # 7 dims, ~0.05%
        lo, hi = _loc_range(rng, 0.35)
        gt = float(rng.integers(0, 3))
        return T.RangeQuery.partial(M, {
            0: (chrom, chrom), 1: (lo, hi), 2: (20.0, 100.0), 3: (10.0, 1500.0),
            6: (0.02, 0.95), 17: (gt, gt), 13: (1.0, 1.0),
        })
    if k == 8:      # 19 dims complete match, ~1e-7
        assert dataset is not None, "template 8 needs the dataset to center on"
        rec = dataset.cols[:, rng.integers(dataset.n)]
        lo = rec.copy()
        hi = rec.copy()
        lo[1] = max(0.0, rec[1] - 5e4)
        hi[1] = rec[1] + 5e4
        lo[2], hi[2] = max(0, rec[2] - 5), min(100, rec[2] + 5)
        lo[3], hi[3] = max(1, rec[3] * 0.5), rec[3] * 2.0
        lo[6], hi[6] = max(0, rec[6] - 0.05), min(1, rec[6] + 0.05)
        lo[18], hi[18] = max(1, rec[18] - 10), min(90, rec[18] + 10)
        lo[5], hi[5] = 0.0, float(dataset.n)  # variation_id: full range
        return T.RangeQuery.complete(lo, hi)
    raise ValueError(f"template k must be 1..8, got {k}")


def mixed_workload(
    dataset: T.Dataset, n_queries: int, seed: int = 0
) -> list[tuple[int, T.RangeQuery]]:
    """The paper's Mixed Workload: all templates randomly interleaved."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_queries):
        k = int(rng.integers(1, 9))
        out.append((k, template(k, rng, dataset)))
    return out

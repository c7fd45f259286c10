"""repro_torch.data — GMRQB and the synthetic datasets (numpy generators)."""
from repro_torch.data.synthetic import (
    power, random_pair_query, selectivity_targeted_query, synt_clust, synt_uni,
    workload,
)

__all__ = [
    "power", "random_pair_query", "selectivity_targeted_query", "synt_clust",
    "synt_uni", "workload",
]

"""repro_torch.data — GMRQB and the synthetic datasets (numpy generators),
and the MDRQ-filtered training data pipeline."""
from repro_torch.data.synthetic import (
    power, random_pair_query, selectivity_targeted_query, synt_clust, synt_uni,
    workload,
)
from repro_torch.data.pipeline import (DataConfig, FilteredTokenPipeline,
                                       default_filter)

__all__ = [
    "power", "random_pair_query", "selectivity_targeted_query", "synt_clust",
    "synt_uni", "workload", "DataConfig", "FilteredTokenPipeline",
    "default_filter",
]

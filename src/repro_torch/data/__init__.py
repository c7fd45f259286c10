"""repro_torch.data — GMRQB and the synthetic datasets (numpy generators)."""
from repro_torch.data.synthetic import synt_clust, synt_uni

__all__ = ["synt_clust", "synt_uni"]

"""repro_torch.core — the MDRQ engine's scan slice, in PyTorch.

Public API:
  * types: ``RangeQuery``, ``QueryBatch``, ``Dataset`` + numpy oracles
  * result specs: ``Ids``, ``Count``, ``Mask``, ``TopK``, ``Agg``
  * engine: ``MDRQEngine`` (the access-path registry), ``engine_from_arrays``
  * access-path layer: ``AccessPath`` protocol + adapters (``core.paths``)
  * planning: ``Planner``, ``Histograms``, ``CostModel``, ``BatchPlan``
"""
from repro_torch.core.types import (Agg, Count, Dataset, Ids, Mask,
                                    QueryBatch, RangeQuery, ResultSpec, TopK,
                                    match_ids_np, match_mask_np,
                                    register_result_spec, resolve_spec)
from repro_torch.core.engine import BatchStats, MDRQEngine, PendingBatch
from repro_torch.core.paths import AccessPath, PerQueryPath, PlanInputs
from repro_torch.core.scan import build_columnar_scan
from repro_torch.core.planner import (BatchPlan, CalibrationFit,
                                      CalibrationReport, CostModel,
                                      Histograms, Planner)
from repro_torch.core.state import engine_from_arrays

__all__ = [
    "Dataset", "QueryBatch", "RangeQuery", "match_ids_np", "match_mask_np",
    "resolve_spec", "ResultSpec", "Ids", "Count", "Mask", "TopK", "Agg",
    "register_result_spec",
    "MDRQEngine", "BatchStats", "PendingBatch", "engine_from_arrays",
    "AccessPath", "PerQueryPath", "PlanInputs", "build_columnar_scan",
    "BatchPlan", "CalibrationFit", "CalibrationReport", "CostModel",
    "Histograms", "Planner",
]

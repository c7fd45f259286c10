"""repro_torch.core — the MDRQ engine in PyTorch, with its mutable plane.

Public API:
  * types: ``RangeQuery``, ``QueryBatch``, ``Dataset`` + numpy oracles
  * result specs: ``Ids``, ``Count``, ``Mask``, ``TopK``, ``Agg``
  * structures: ``build_columnar_scan``, ``build_row_scan`` (``RowScan``),
    ``build_kdtree``, ``build_rstar``, ``build_vafile`` (``BlockedIndex``,
    ``VAFile``)
  * mutable plane: ``MutableDelta``, ``DeltaView``, ``Compactor``,
    ``DeltaHostCtx``
  * engine: ``MDRQEngine`` (the access-path registry), ``engine_from_arrays``
  * horizontal partitioning: ``DistributedScan``, ``make_data_mesh``
    (``DataMesh``; ``MDRQEngine(mesh=...)`` shards the scan)
  * access-path layer: ``AccessPath`` protocol + adapters (``core.paths``)
  * planning: ``Planner``, ``Histograms``, ``CostModel``, ``BatchPlan``
"""
from repro_torch.core.types import (Agg, Count, Dataset, DeltaHostCtx, Ids,
                                    Mask, QueryBatch, RangeQuery, ResultSpec,
                                    TopK,
                                    match_ids_np, match_mask_np,
                                    register_result_spec, resolve_spec)
from repro_torch.core.engine import BatchStats, MDRQEngine, PendingBatch
from repro_torch.core.paths import (AccessPath, BlockedIndexPath,
                                    PerQueryPath, PlanInputs, VAFilePath)
from repro_torch.core.scan import RowScan, build_columnar_scan, build_row_scan
from repro_torch.core.delta import Compactor, DeltaView, MutableDelta
from repro_torch.core.blockindex import BlockedIndex
from repro_torch.core.kdtree import build_kdtree
from repro_torch.core.rstar import build_rstar
from repro_torch.core.vafile import VAFile, build_vafile
from repro_torch.core.planner import (BatchPlan, CalibrationFit,
                                      CalibrationReport, CostModel,
                                      Histograms, Planner)
from repro_torch.core.state import engine_from_arrays
from repro_torch.core.distributed import (DataMesh, DistributedScan,
                                          make_data_mesh)

__all__ = [
    "Dataset", "QueryBatch", "RangeQuery", "match_ids_np", "match_mask_np",
    "resolve_spec", "ResultSpec", "Ids", "Count", "Mask", "TopK", "Agg",
    "register_result_spec",
    "MDRQEngine", "BatchStats", "PendingBatch", "engine_from_arrays",
    "AccessPath", "PerQueryPath", "PlanInputs", "BlockedIndexPath",
    "VAFilePath", "build_columnar_scan", "build_kdtree", "build_rstar",
    "build_vafile", "BlockedIndex", "VAFile", "RowScan", "build_row_scan",
    "MutableDelta", "DeltaView", "Compactor", "DeltaHostCtx",
    "BatchPlan", "CalibrationFit", "CalibrationReport", "CostModel",
    "Histograms", "Planner", "DataMesh", "DistributedScan", "make_data_mesh",
]

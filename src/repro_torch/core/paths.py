"""The access-path layer: one protocol behind every MDRQ execution engine.

Ports ``repro/core/paths.py``: ``AccessPath`` is the protocol every path
speaks, ``ColumnarScanPath`` and ``VerticalScanPath`` put the columnar scan
behind it (``DistributedScanPath`` the sharded scan of a meshed engine),
``BlockedIndexPath`` the kd-tree and the R*-tree, ``VAFilePath``
the VA-file, ``PerQueryPath`` adapts anything that only has single-query
methods, and ``MDRQEngine`` is a name -> path registry.

Planning rides the same protocol: each path prices itself, scalar (``cost``,
the single-query ``Planner.explain`` hook) and vectorized (``cost_batch``,
the (paths x Q) matrix ``Planner.plan_batch`` builds from one ``PlanInputs``
pass). The four cost mixins delegate to ``CostModel`` so the paths and the
planner's structure-free planning stubs share one set of formulas.

Conventions:

  * ``cost``/``cost_batch`` return ``inf`` where the path is not applicable
    (the vertical scan on a complete-match query) — the planner skips
    non-finite entries.
  * ``plannable=False`` paths execute only when named explicitly (the row
    scan; the vertical scan on a meshed engine, where an "auto" choice would
    place a second, unsharded copy of the dataset on one device).
  * ``owns_storage=False`` marks views over another path's arrays so
    ``memory_report`` never double-counts.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Callable, Protocol, Union, runtime_checkable

import numpy as np

from repro_torch.obs import tracing as obs_tracing
from repro_torch.core import types as T


def _path_span(path, batch, spec, stage: str | None = None):
    """Span around one adapter batch execution (``NULL_SPAN`` unless a tracer
    is active, so the disabled hot path allocates nothing). ``stage="launch"``
    marks the device-stage half of a split execution: that span does not
    wait for the device."""
    if not obs_tracing.enabled():
        return obs_tracing.NULL_SPAN
    if stage is None:
        return obs_tracing.span("path", path=path.name, n_queries=len(batch),
                                spec=getattr(spec, "kind", str(spec)))
    return obs_tracing.span("path", path=path.name, n_queries=len(batch),
                            spec=getattr(spec, "kind", str(spec)), stage=stage)


def supports_launch(path) -> bool:
    """Whether a path offers the split-execution protocol:
    ``launch_batch(batch, spec) -> (payload, finalize)`` where the caller
    owns the single ``ops.device_get(payload)`` and ``finalize(host_payload)``
    types the per-query results."""
    return callable(getattr(path, "launch_batch", None))


@functools.lru_cache(maxsize=None)
def _fn_takes_spec(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables
        return False
    return "spec" in params or any(p.kind == p.VAR_KEYWORD
                                   for p in params.values())


def takes_spec(method) -> bool:
    """Whether a path hook (``query_batch``/``cost``/``cost_batch``/
    ``launch_batch``) accepts the ``spec`` argument of the ResultSpec
    protocol. Paths without it are served and priced as Ids only. The
    signature probe is cached on the underlying function object."""
    return _fn_takes_spec(getattr(method, "__func__", method))


@functools.lru_cache(maxsize=None)
def _fn_takes_delta(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables
        return False
    return "delta" in params or any(p.kind == p.VAR_KEYWORD
                                    for p in params.values())


def takes_delta(method) -> bool:
    """Whether a path's ``query_batch`` (or ``launch_batch``) accepts the
    ``delta`` argument of the versioned-dataset protocol (a
    ``core.delta.DeltaView``). The engine hands a non-empty delta only to
    paths that declare it; others raise a "compact() first" error instead of
    serving stale results. Cached like ``takes_spec``."""
    return _fn_takes_delta(getattr(method, "__func__", method))


# Per-query results under some ResultSpec: id arrays (Ids/TopK), ints
# (Count), bool masks (Mask), or floats (Agg).
Results = Union["list[np.ndarray]", "list[int]", "list[float]"]


@dataclasses.dataclass(frozen=True)
class PlanInputs:
    """Per-query planning statistics for one batch, computed in one pass."""

    lower: np.ndarray      # (Q, m) float32 query lower bounds
    upper: np.ndarray      # (Q, m) float32 query upper bounds
    dims_mask: np.ndarray  # (Q, m) bool — True where a dim is constrained
    mq: np.ndarray         # (Q,) int — number of constrained dims
    dim_sels: np.ndarray   # (Q, m) per-dim selectivity (1.0 if unconstrained)
    sels: np.ndarray       # (Q,) independence-assumption query selectivity

    def __len__(self) -> int:
        return self.lower.shape[0]

    @property
    def is_complete(self) -> np.ndarray:
        """(Q,) bool — queries constraining every dimension."""
        return self.dims_mask.all(axis=1)


@runtime_checkable
class AccessPath(Protocol):
    """What the engine registry and the planner require of a path."""

    name: str
    plannable: bool
    owns_storage: bool

    @property
    def nbytes_index(self) -> int: ...

    def query(self, q: T.RangeQuery) -> np.ndarray: ...

    def count(self, q: T.RangeQuery) -> int: ...

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS) -> Results: ...

    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float: ...

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray: ...


# -- cost mixins --------------------------------------------------------------
# One mixin per cost shape, delegating to the CostModel formulas. ``bucket``
# is the (Q,) per-query amortization size the planner's fixpoint converged on.

class ScanCost:
    """Full fused scan: cost is query-independent except for amortization."""

    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float:
        return model.cost_scan(q, batch=batch, spec=spec)

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray:
        return model.cost_scan_batch(len(pi), bucket, spec=spec)


class VerticalScanCost:
    """Partial-match scan: touches only constrained columns; inapplicable
    (inf) to complete-match queries, where it degenerates to the full scan."""

    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float:
        if q.is_complete_match:
            return float("inf")
        return model.cost_scan_vertical(q, batch=batch, spec=spec)

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray:
        return np.where(pi.is_complete, np.inf,
                        model.cost_scan_vertical_batch(pi.mq, bucket,
                                                       spec=spec))


class TreeCost:
    """Blocked tree MDIS (kd-tree / R*-tree): prune + visit two-phase cost."""

    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float:
        return model.cost_tree(q, sel, batch=batch, spec=spec)

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray:
        return model.cost_tree_batch(pi.sels, pi.mq, bucket, spec=spec)


class VAFileCost:
    """VA-file: packed approximation stream + candidate-block refinement."""

    hist: Any  # Histograms — the scalar candidate-fraction estimate needs it

    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float:
        return model.cost_vafile(q, self.hist, batch=batch, spec=spec)

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray:
        return model.cost_vafile_batch(pi.dim_sels, pi.dims_mask, bucket,
                                       spec=spec)


# -- adapters over the columnar scan ------------------------------------------

class ColumnarScanPath(ScanCost):
    """``ColumnarScan`` as the "scan" path (single-device full fused scan)."""

    name = "scan"
    plannable = True
    owns_storage = True

    def __init__(self, scan):
        self._scan = scan

    @property
    def nbytes_index(self) -> int:
        return self._scan.nbytes_index

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._scan.query(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._scan.count(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        with _path_span(self, batch, spec) as sp:
            out = self._scan.query_batch(batch, spec=spec, delta=delta)
            sp.block_on(out)
        return out

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        with _path_span(self, batch, spec, stage="launch"):
            return self._scan.launch_batch(batch, spec=spec, delta=delta)


class DistributedScanPath(ScanCost):
    """``DistributedScan`` as the "scan" path — one counted op per batch,
    data sharded over a mesh (horizontal partitioning, §3.1)."""

    name = "scan"
    plannable = True
    owns_storage = True

    def __init__(self, dist):
        self._dist = dist

    @property
    def nbytes_index(self) -> int:
        return self._dist.nbytes_index

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._dist.query(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._dist.count(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        with _path_span(self, batch, spec) as sp:
            out = self._dist.query_batch(batch, spec=spec, delta=delta)
            sp.block_on(out)
        return out

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        with _path_span(self, batch, spec, stage="launch"):
            return self._dist.launch_batch(batch, spec=spec, delta=delta)


class VerticalScanPath(VerticalScanCost):
    """The partial-match vertical scan (§5.5) as its own path: a *view* over
    the columnar scan's storage (``owns_storage=False``), reached through
    ``scan_ref`` so a meshed engine builds that copy only when the path is
    named."""

    name = "scan_vertical"
    owns_storage = False

    def __init__(self, scan_ref: Callable[[], Any], plannable: bool = True):
        self._scan_ref = scan_ref
        self.plannable = plannable

    @property
    def nbytes_index(self) -> int:
        return 0

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._scan_ref().query_partial(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._scan_ref().count_partial(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        with _path_span(self, batch, spec) as sp:
            out = self._scan_ref().query_batch(batch, partial=True, spec=spec,
                                               delta=delta)
            sp.block_on(out)
        return out

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        with _path_span(self, batch, spec, stage="launch"):
            return self._scan_ref().launch_batch(batch, partial=True,
                                                 spec=spec, delta=delta)


# -- adapters over the two-phase indexes --------------------------------------

class BlockedIndexPath(TreeCost):
    """A ``BlockedIndex`` (kd-tree or packed STR R*-tree) as a path."""

    plannable = True
    owns_storage = True

    def __init__(self, index):
        self._index = index
        self.name = index.name

    @property
    def nbytes_index(self) -> int:
        return self._index.nbytes_index

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._index.query(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._index.count(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        with _path_span(self, batch, spec) as sp:
            out = self._index.query_batch(batch, spec=spec, delta=delta)
            sp.block_on(out)
        return out

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        with _path_span(self, batch, spec, stage="launch"):
            return self._index.launch_batch(batch, spec=spec, delta=delta)


class VAFilePath(VAFileCost):
    """A ``VAFile`` as a path (two-phase approximation scan)."""

    name = "vafile"
    plannable = True
    owns_storage = True

    def __init__(self, vafile, hist):
        self._vafile = vafile
        self.hist = hist

    @property
    def nbytes_index(self) -> int:
        return self._vafile.nbytes_index

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._vafile.query(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._vafile.count(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        with _path_span(self, batch, spec) as sp:
            out = self._vafile.query_batch(batch, spec=spec, delta=delta)
            sp.block_on(out)
        return out

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        with _path_span(self, batch, spec, stage="launch"):
            return self._vafile.launch_batch(batch, spec=spec, delta=delta)


class PerQueryPath:
    """Generic adapter: any object with single-query ``query``/``count``
    becomes a full ``AccessPath`` whose batch execution is a per-query loop.

    Structures without a fused batch kernel (``RowScan``, prototypes, test
    doubles) still ride the registry, paying Q launches instead of one. Reduced result
    shapes ride the spec's *host* fallback: ids materialize per query and
    ``ResultSpec.from_ids`` finalizes against the host columns (pass ``cols``
    to enable — specs that read attribute values need it). Not plannable by
    default.
    """

    owns_storage = True

    def __init__(self, name: str, impl, plannable: bool = False,
                 cols: np.ndarray | None = None):
        self.name = name
        self._impl = impl
        self.plannable = plannable
        self._cols = cols

    @property
    def nbytes_index(self) -> int:
        return int(getattr(self._impl, "nbytes_index", 0))

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return self._impl.query(q)

    def count(self, q: T.RangeQuery) -> int:
        return self._impl.count(q)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> Results:
        spec = T.resolve_spec(spec)
        with _path_span(self, batch, spec):
            if delta is not None and not delta.is_empty:
                return self._query_batch_delta(batch, spec, delta)
            if spec.kind == "ids":
                return [self.query(batch[k]) for k in range(len(batch))]
            if spec.kind == "count":
                return [self.count(batch[k]) for k in range(len(batch))]
            if self._cols is None:
                raise ValueError(
                    f"path {self.name!r} has no host columns for result spec "
                    f"{spec.kind!r}; construct PerQueryPath(..., cols=...)")
            return [spec.from_ids(self.query(batch[k]), self._cols)
                    for k in range(len(batch))]

    def _query_batch_delta(self, batch: T.QueryBatch, spec: T.ResultSpec,
                           delta) -> Results:
        # Host-side delta merge: the wrapped singles see only the frozen
        # base, so per query drop base tombstones, append the delta's host
        # match, and finalize every spec from ids against the combined
        # columns (this rung already pays Q host round trips).
        cols = delta.combined_cols()
        out = []
        for k in range(len(batch)):
            q = batch[k]
            ids = np.asarray(self.query(q), np.int64)
            if delta.has_base_tombs:
                ids = ids[~delta.base_tomb[ids]]
            ids = np.concatenate([ids, delta.match_delta_ids(q)])
            out.append(ids if spec.kind == "ids" else spec.from_ids(ids, cols))
        return out

    # A plannable=False path is never priced; keep the protocol total anyway.
    def cost(self, q: T.RangeQuery, sel: float, batch: int, model,
             spec: T.ResultSpec = T.IDS) -> float:
        return float("inf")

    def cost_batch(self, pi: PlanInputs, bucket: np.ndarray, model,
                   spec: T.ResultSpec = T.IDS) -> np.ndarray:
        return np.full((len(pi),), np.inf, np.float64)

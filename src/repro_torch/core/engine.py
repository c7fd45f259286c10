"""MDRQEngine — a registry of access paths behind one query interface.

Ports ``repro/core/engine.py`` on one device. The engine places a columnar
dataset on the device, builds the structures it is asked for — by default
the reference's four: the columnar scan (served as ``scan`` and
``scan_vertical``), the blocked kd-tree, the packed STR R*-tree and the
VA-file, plus the row-major scan with ``rowscan=True`` — registers each
behind its ``core.paths`` adapter, and answers range queries either with an
explicitly named path or through the planner ("auto").

Horizontal partitioning: ``mesh=`` (a ``core.distributed.DataMesh``) makes
``"scan"`` the sharded scan — data split over the mesh's shards, one counted
op per batch — and the planner prices the scan for the mesh's D shards. The
single-device columnar copy is then built only when a path that runs on it
is used (the vertical scan, by name only; the VA-file, at build).

The mutable plane: ``append``/``delete`` land in a versioned delta segment
(``core.delta``) that every batch launch scans beside the frozen structures,
and ``compact`` folds it back into freshly built structures. Each version —
structures, registry, planner, delta — is one ``_EngineState``; a query call
reads the engine's state and the delta's snapshot once, so a concurrent
compaction swap never mixes two versions inside one call.

Batched execution: ``query_batch`` takes a whole stream of queries at once.
The planner's vectorized fixpoint (``Planner.plan_batch``) assigns every
query an access path, each bucket executes through one fused multi-query
launch that carries the ``ResultSpec``'s on-device reducer, one counted
``device_get`` brings the payload back, and the spec's host finalizer types
the per-query results. ``BatchStats`` splits ``plan_seconds`` from execution.

Device rule: the engine runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card the default fails loudly. ``backend="torch"``
runs the plain PyTorch versions of the kernels on the same device — the
reference the hand kernels are held against.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.kernels import ops
from repro_torch.core import types as T
from repro_torch.core import delta as delta_mod
from repro_torch.core import scan as scan_mod
from repro_torch.core import paths as paths_mod
from repro_torch.core.distributed import DataMesh, DistributedScan
from repro_torch.core.kdtree import build_kdtree
from repro_torch.core.planner import CostModel, Histograms, Planner
from repro_torch.core.rstar import build_rstar
from repro_torch.core.vafile import build_vafile

# The structures ``structures`` can name (the reference's default set); the
# row-major scan is the ``rowscan=True`` flag, as in the reference.
STRUCTURES = ("scan", "kdtree", "rstar", "vafile")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev


@dataclasses.dataclass
class QueryStats:
    method: str
    seconds: float
    n_results: int
    est_selectivity: float


@dataclasses.dataclass
class BatchStats:
    """Aggregate statistics of one ``query_batch`` execution.

    ``seconds`` is the whole wall time (planning + execution);
    ``plan_seconds`` is the planning share of it.
    """

    n_queries: int
    seconds: float
    method_counts: dict[str, int]
    n_results: int
    plan_seconds: float = 0.0
    # per-query chosen path, positionally aligned with the input batch
    methods: Optional[list[str]] = None

    @property
    def qps(self) -> float:
        return self.n_queries / self.seconds if self.seconds > 0 else 0.0


def _n_results(spec: T.ResultSpec, results: Sequence) -> int:
    """Total result magnitude across per-query results, typed by the spec."""
    return int(sum(spec.result_size(r) for r in results))


@dataclasses.dataclass
class PendingBatch:
    """An in-flight batch: device work launched, host finalization deferred.

    Produced by ``MDRQEngine.launch_batch``; ``finalize()`` performs each
    bucket's single counted ``ops.device_get`` and the spec's host
    finalizers, returning the per-query results positionally aligned with the
    input. Everything the finalize needs was captured at launch (the state
    version, the delta snapshot inside each finalize closure), so a
    concurrent ingest or compaction swap cannot mix versions mid-batch.
    ``stats`` is filled by ``finalize()`` but not written to
    ``engine.last_batch_stats``.
    """

    n_queries: int
    spec: T.ResultSpec
    methods: list[str]
    method_counts: dict[str, int]
    plan_seconds: float
    launch_seconds: float
    version: int
    # per-bucket (input positions, in-flight device payload | None, finalize)
    _parts: list = dataclasses.field(default_factory=list)
    stats: Optional[BatchStats] = None

    def finalize(self) -> list:
        """Host stage: sync each bucket's payload, run the host finalizers,
        scatter per-query results back to input order. Call once."""
        t0 = time.perf_counter()
        results: list = [None] * self.n_queries
        for idxs, payload, fin in self._parts:
            host = ops.device_get(payload) if payload is not None else None
            out = fin(host)
            for k, res in zip(idxs, out):
                results[k] = res
        dt = time.perf_counter() - t0
        self.stats = BatchStats(
            n_queries=self.n_queries,
            seconds=self.plan_seconds + self.launch_seconds + dt,
            method_counts=dict(self.method_counts),
            n_results=_n_results(self.spec, results),
            plan_seconds=self.plan_seconds,
            methods=list(self.methods),
        )
        return results


def _lookup_path(paths: dict, method: str) -> paths_mod.AccessPath:
    path = paths.get(method)
    if path is None:
        raise ValueError(f"unknown method {method!r}; "
                         f"options: {tuple(paths)} or 'auto'")
    return path


def _as_batch(queries) -> Optional[T.QueryBatch]:
    if isinstance(queries, T.QueryBatch):
        return queries
    queries = list(queries)
    return T.QueryBatch.from_queries(queries) if queries else None


class _LazyColumnar:
    """The single-device columnar scan, built at first use. A meshed engine
    holds its data sharded; this copy appears only when a path that runs on
    it is used. (A holder, not the state: the vertical scan's view reaches
    this, never the state itself.)"""

    def __init__(self, dataset: T.Dataset, tile_n: int, device, backend: str,
                 build_seconds: dict, name: str):
        self._args = (dataset, tile_n, device, backend)
        self._build_seconds = build_seconds
        self._name = name   # its build_seconds entry
        self.scan: Optional[scan_mod.ColumnarScan] = None

    def get(self) -> scan_mod.ColumnarScan:
        if self.scan is None:
            dataset, tile_n, device, backend = self._args
            t0 = time.perf_counter()
            self.scan = scan_mod.build_columnar_scan(
                dataset, tile_n=tile_n, device=device, backend=backend)
            self._build_seconds[self._name] = time.perf_counter() - t0
        return self.scan


class _EngineState:
    """One immutable *version* of the engine: the structures built from a
    dataset snapshot, their access-path registry and planner, and the
    mutable delta segment layered on top.

    Queries read ``MDRQEngine._state`` once and work off the captured
    object, so the compactor's swap — a single attribute assignment — can
    never mix structures of two versions inside one call.
    """

    def __init__(self, dataset: T.Dataset, structures: tuple[str, ...],
                 tile_n: int, rowscan: bool, device: torch.device,
                 backend: str, mesh: Optional[DataMesh] = None,
                 version: int = 0):
        self.dataset = dataset
        self.version = version
        # host seconds of each structure's build (numpy, then the copy to
        # the device), for the build report
        self.build_seconds: dict[str, float] = {}

        def build(name, wanted, fn, **placement):
            if not wanted:
                return None
            t0 = time.perf_counter()
            out = fn(dataset, backend=backend, **placement)
            self.build_seconds[name] = time.perf_counter() - t0
            return out

        # With a mesh, "scan" is the sharded scan (one counted op per batch
        # over every shard), and the single-device copy waits for its first
        # use; without one, that copy is the scan.
        self.dist = build("scan", mesh is not None, DistributedScan,
                          mesh=mesh, tile_n=tile_n)
        self._lazy = _LazyColumnar(dataset, tile_n, device, backend,
                                   self.build_seconds,
                                   "scan" if mesh is None else "columnar")
        if mesh is None:
            self._lazy.get()
        self.kdtree = build("kdtree", "kdtree" in structures, build_kdtree,
                            tile_n=tile_n, device=device)
        self.rstar = build("rstar", "rstar" in structures, build_rstar,
                           tile_n=tile_n, device=device)
        # The VA-file refines in storage order: it shares the single-device
        # copy (on a meshed engine, building it builds that copy).
        self.vafile = (build("vafile", True, build_vafile, tile_n=tile_n,
                             data_dev=self.columnar.data_dev)
                       if "vafile" in structures else None)
        self.rowscan = build("rowscan", rowscan, scan_mod.build_row_scan,
                             device=device)
        self.hist = Histograms.build(dataset)
        # The mutable plane over this frozen version: appended rows and
        # tombstones, scanned by every batch launch beside the structures.
        self.delta = delta_mod.MutableDelta(dataset)
        # Every built structure registers as a plannable path, or "auto"
        # could never choose it.
        self.paths: dict[str, paths_mod.AccessPath] = {}
        # The view captures the holder, not ``self``: a state must not reach
        # itself, or a replaced version's device tensors would wait for the
        # cycle collector instead of going at the compaction swap.
        lazy = self._lazy
        if self.dist is not None:
            self.add_path(paths_mod.DistributedScanPath(self.dist))
            # Not plannable here: an "auto" choice would place a second,
            # unsharded copy of the dataset on one device.
            self.add_path(paths_mod.VerticalScanPath(lazy.get,
                                                     plannable=False))
        else:
            self.add_path(paths_mod.ColumnarScanPath(lazy.get()))
            self.add_path(paths_mod.VerticalScanPath(lazy.get))
        if self.rowscan is not None:
            # No fused batch kernel for the row layout: the per-query rung;
            # the host columns serve the reduced specs' from_ids.
            self.add_path(paths_mod.PerQueryPath("rowscan", self.rowscan,
                                                 cols=dataset.cols))
        for index in (self.kdtree, self.rstar):
            if index is not None:
                self.add_path(paths_mod.BlockedIndexPath(index))
        if self.vafile is not None:
            self.add_path(paths_mod.VAFilePath(self.vafile, self.hist))
        # The planner shares the registry dict: paths registered later are
        # planned without rebuilding anything.
        # A mesh's D shards price the scan as D devices would, as the
        # reference does, even where several shards share one card.
        self.planner = Planner(
            self.hist, CostModel(n=dataset.n, m=dataset.m, tile_n=tile_n,
                                 n_devices=(mesh.size if mesh is not None
                                            else 1)),
            paths=self.paths)

    @property
    def columnar(self) -> scan_mod.ColumnarScan:
        """The single-device columnar scan (built now if it was not)."""
        return self._lazy.get()

    @property
    def _columnar(self) -> Optional[scan_mod.ColumnarScan]:
        """The single-device columnar scan, or None while it is unbuilt."""
        return self._lazy.scan

    def add_path(self, path: paths_mod.AccessPath) -> None:
        for attr in ("name", "plannable", "owns_storage", "nbytes_index",
                     "query", "count", "query_batch", "cost", "cost_batch"):
            if not hasattr(path, attr):
                raise TypeError(f"access path lacks {attr!r} "
                                f"(see core.paths.AccessPath)")
        self.paths[path.name] = path


class MDRQEngine:
    """Build-once, query-many MDRQ engine over one device (or, for the scan,
    the shards of a ``mesh``), with a mutable plane: ``append``/``delete``
    land in a versioned delta segment and ``compact`` folds it back into
    freshly built structures.

    ``device`` defaults to the mesh's first device on a meshed engine, else
    to ``cuda``; the structures other than the sharded scan live there.
    """

    def __init__(
        self,
        dataset: T.Dataset,
        structures: tuple[str, ...] = STRUCTURES,
        tile_n: int = 1024,
        rowscan: bool = False,
        device=None,
        backend: str = "auto",
        mesh: Optional[DataMesh] = None,
    ):
        for name in structures:
            if name not in STRUCTURES:
                raise ValueError(f"unknown structure {name!r}; options: "
                                 f"{STRUCTURES} (the row-major scan is "
                                 f"rowscan=True)")
        # Build parameters persist so ``compact`` rebuilds the same set.
        self._structures = tuple(structures)
        self.tile_n = tile_n
        self._rowscan_enabled = bool(rowscan)
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a core.distributed.DataMesh, got "
                            f"{type(mesh).__name__}")
        self._mesh = mesh
        self.device = resolve_device(
            mesh.first if device is None and mesh is not None else device)
        self._backend = ops.check_backend(backend)
        # Serializes the write side (append/delete/compact-commit); the read
        # side is lock-free — queries capture ``self._state`` once.
        self._ingest_lock = threading.Lock()
        self._state = self._build_state(dataset, version=0)
        self.last_stats: Optional[QueryStats] = None
        self.last_batch_stats: Optional[BatchStats] = None
        self.last_trace: Optional[obs_tracing.BatchTrace] = None

    def _build_state(self, dataset: T.Dataset, version: int = 0) -> _EngineState:
        return _EngineState(dataset, self._structures, self.tile_n,
                            self._rowscan_enabled, self.device, self._backend,
                            mesh=self._mesh, version=version)

    # -- versioned-state views ---------------------------------------------
    # Callers read these as plain attributes; each delegates to the
    # *current* version. Code that must be swap-consistent (query,
    # query_batch, launch_batch, the Compactor) captures ``self._state``
    # once instead.
    @property
    def dataset(self) -> T.Dataset:
        return self._state.dataset

    @property
    def mesh(self) -> Optional[DataMesh]:
        return self._mesh

    @property
    def dist(self) -> Optional[DistributedScan]:
        """The sharded scan of a meshed engine (None without a mesh)."""
        return self._state.dist

    @property
    def columnar(self) -> scan_mod.ColumnarScan:
        """The single-device columnar scan; on a meshed engine reading it
        builds it."""
        return self._state.columnar

    @property
    def _columnar(self) -> Optional[scan_mod.ColumnarScan]:
        # None until a meshed engine's single-device copy is built
        return self._state._columnar

    @property
    def kdtree(self):
        return self._state.kdtree

    @property
    def rstar(self):
        return self._state.rstar

    @property
    def vafile(self):
        return self._state.vafile

    @property
    def rowscan(self):
        return self._state.rowscan

    @property
    def hist(self) -> Histograms:
        return self._state.hist

    @property
    def paths(self) -> dict[str, paths_mod.AccessPath]:
        return self._state.paths

    @property
    def planner(self) -> Planner:
        return self._state.planner

    @property
    def build_seconds(self) -> dict[str, float]:
        return self._state.build_seconds

    @property
    def delta(self) -> delta_mod.MutableDelta:
        return self._state.delta

    @property
    def version(self) -> int:
        """Monotone dataset version: bumps on every compaction swap."""
        return self._state.version

    # -- the mutable plane (append / delete / compact) ----------------------
    def append(self, rows) -> np.ndarray:
        """Append rows ((k, m) array-like) -> their assigned int64 ids.

        Rows land in the current version's delta segment and are visible to
        every later query: the fused batch ops scan the delta block beside
        the frozen structures (same counted op, same host sync).
        """
        with self._ingest_lock:
            return self._state.delta.append(rows)

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta rows) -> count of newly deleted."""
        with self._ingest_lock:
            return self._state.delta.delete(ids)

    def compact(self) -> np.ndarray:
        """Merge delta rows + tombstones into freshly built structures and
        swap the engine to the new version atomically.

        Returns the id map (old id -> new id, -1 for deleted rows). The
        build runs outside the ingest lock — serving and ingest continue on
        the old version, and both versions are on the device until the swap
        — and the commit re-folds anything ingested during the build into
        the new version's delta before swapping ``_state`` in a single
        assignment.
        """
        with obs_tracing.span("compact", version=self._state.version):
            comp = delta_mod.Compactor(self)
            comp.build()
            return comp.commit()

    # -- the registry ------------------------------------------------------
    def register_path(self, path: paths_mod.AccessPath) -> None:
        """Register (or replace) an access path under ``path.name``; the
        planner sees it immediately. Registration binds to the *current*
        version — a later ``compact`` rebuilds the registry from the
        engine's build parameters, so external paths re-register after a
        swap."""
        self._state.add_path(path)

    def memory_report(self) -> dict[str, int]:
        """Host bytes of the dataset and of the mutable plane ("delta":
        segment rows + both tombstone bitmaps), and the auxiliary bytes of
        each storage-owning path (a view over another path's arrays, as the
        vertical scan is, would double-count)."""
        state = self._state
        rep = {"data": state.dataset.nbytes, "delta": state.delta.nbytes}
        for name, path in state.paths.items():
            if path.owns_storage:
                rep[name] = path.nbytes_index
        return rep

    @staticmethod
    def _path_query_batch(path, sub: T.QueryBatch, spec: T.ResultSpec,
                          delta=None) -> list:
        """Run one bucket through a path under ``spec`` (and ``delta``).

        A path whose ``query_batch`` takes no spec serves Ids only. A
        non-empty delta goes only to paths that declare the parameter —
        anything else would silently drop the appended rows.
        """
        if delta is not None:
            if not paths_mod.takes_delta(path.query_batch):
                raise ValueError(
                    f"access path {path.name!r} is not delta-aware; "
                    f"call compact() first")
            return path.query_batch(sub, spec=spec, delta=delta)
        if paths_mod.takes_spec(path.query_batch):
            return path.query_batch(sub, spec=spec)
        if spec.kind == "ids":
            return path.query_batch(sub)
        raise ValueError(f"path {path.name!r} predates the ResultSpec "
                         f"protocol and cannot serve spec {spec.kind!r}")

    @staticmethod
    def _path_supports_launch(path, delta) -> bool:
        """Whether this bucket can use the split launch/finalize protocol
        (else it executes synchronously inside the device stage)."""
        if not (paths_mod.supports_launch(path)
                and paths_mod.takes_spec(path.launch_batch)):
            return False
        return delta is None or paths_mod.takes_delta(path.launch_batch)

    @staticmethod
    def _plan(state: _EngineState, batch: T.QueryBatch, method: str,
              spec: T.ResultSpec, delta_n: int):
        """-> (BatchPlan or None, per-query methods)."""
        with obs_tracing.span("plan", n_queries=len(batch)):
            # The delta's size is a per-version cost axis: every path pays
            # an extra delta scan per batch, amortized over its bucket —
            # which can flip index picks to the scan as the delta grows.
            state.planner.model.delta_n = delta_n
            if method == "auto":
                bp = state.planner.plan_batch(batch, spec=spec)
                return bp, bp.methods
            _lookup_path(state.paths, method)  # raise before work
            return None, [method] * len(batch)

    @staticmethod
    def _buckets(methods: list[str]) -> dict[str, list[int]]:
        buckets: dict[str, list[int]] = {}
        for k, meth in enumerate(methods):
            buckets.setdefault(meth, []).append(k)
        return buckets

    @staticmethod
    def _count_served(buckets: dict[str, list[int]]) -> None:
        reg = obs_metrics.registry()
        reg.counter("mdrq_query_batches_total",
                    help="query_batch executions").inc()
        for meth, idxs in buckets.items():
            reg.counter("mdrq_queries_total",
                        help="queries served, by access path",
                        path=meth).inc(len(idxs))

    @staticmethod
    def _snapshot(state: _EngineState):
        """-> (the delta's view, the view or None when it is empty). One
        snapshot serves a whole call: concurrent appends and deletes become
        visible at the next call, never mid-call."""
        dview = state.delta.snapshot()
        return dview, (None if dview.is_empty else dview)

    def launch_batch(
        self,
        queries: Union[T.QueryBatch, Sequence[T.RangeQuery]],
        method: str = "auto",
        spec: Optional[T.ResultSpec] = None,
    ) -> PendingBatch:
        """Device stage of a split ``query_batch`` -> a ``PendingBatch``.

        Plans the batch and issues every bucket's fused launch;
        ``PendingBatch.finalize()`` performs the deferred host syncs + spec
        finalizers (one counted ``device_get`` per bucket — the same budget
        as the synchronous path). Scan buckets synchronize nothing here; a
        two-phase bucket pays its one shape-deciding sync (the prune's or the
        filter's survivors) here, before its visit launch. Buckets whose path
        lacks the split protocol execute synchronously inside this call. The
        state and the delta snapshot are captured here, once.
        """
        state = self._state
        spec = T.resolve_spec(spec)
        batch = _as_batch(queries)
        if batch is None or len(batch) == 0:
            return PendingBatch(0, spec, [], {}, 0.0, 0.0, state.version)
        if batch.m != state.dataset.m:
            raise ValueError(f"batch dims {batch.m} != dataset dims "
                             f"{state.dataset.m}")
        spec.validate(state.dataset.m)
        dview, delta_arg = self._snapshot(state)
        t0 = time.perf_counter()
        _, methods = self._plan(state, batch, method, spec, dview.d)
        t1 = time.perf_counter()
        buckets = self._buckets(methods)
        pending = PendingBatch(
            n_queries=len(batch), spec=spec, methods=list(methods),
            method_counts={m: len(ix) for m, ix in buckets.items()},
            plan_seconds=t1 - t0, launch_seconds=0.0, version=state.version)
        for meth, idxs in buckets.items():
            sub = T.QueryBatch(batch.lower[idxs], batch.upper[idxs])
            path = _lookup_path(state.paths, meth)
            with obs_tracing.span("execute", path=meth, bucket=len(idxs),
                                  stage="launch"):
                if self._path_supports_launch(path, delta_arg):
                    payload, fin = path.launch_batch(sub, spec=spec,
                                                     delta=delta_arg)
                else:
                    out = self._path_query_batch(path, sub, spec,
                                                 delta=delta_arg)
                    payload, fin = None, (lambda _h, _out=out: _out)
            pending._parts.append((idxs, payload, fin))
        pending.launch_seconds = time.perf_counter() - t1
        self._count_served(buckets)
        return pending

    def query(self, q: T.RangeQuery, method: str = "auto",
              spec: Optional[T.ResultSpec] = None):
        """Execute q under a ResultSpec -> sorted ids (default ``Ids()``),
        an int count, a bool mask, top-k ids, or an aggregate; records
        QueryStats."""
        state = self._state
        if q.m != state.dataset.m:
            raise ValueError(f"query dims {q.m} != dataset dims "
                             f"{state.dataset.m}")
        spec = T.resolve_spec(spec).validate(state.dataset.m)
        dview, delta_arg = self._snapshot(state)
        state.planner.model.delta_n = dview.d
        if method == "auto":
            plan = state.planner.explain(q, spec=spec)
            method, est = plan.method, plan.est_selectivity
        else:
            est = state.planner.hist.selectivity(q)
        path = _lookup_path(state.paths, method)
        t0 = time.perf_counter()
        if delta_arg is not None:
            # The single-query methods see only the frozen base: under a
            # live delta every spec rides the delta-aware batch rung at Q=1.
            res = self._path_query_batch(
                path, T.QueryBatch.from_queries([q]), spec, delta=delta_arg)[0]
        elif spec.kind == "ids":    # dedicated single-query fast paths for
            res = path.query(q)     # the two historical shapes; every other
        elif spec.kind == "count":  # spec rides the batch rung at Q=1
            res = path.count(q)
        else:
            res = self._path_query_batch(
                path, T.QueryBatch.from_queries([q]), spec)[0]
        dt = time.perf_counter() - t0
        self.last_stats = QueryStats(method=method, seconds=dt,
                                     n_results=spec.result_size(res),
                                     est_selectivity=est)
        return res

    def query_batch(
        self,
        queries: Union[T.QueryBatch, Sequence[T.RangeQuery]],
        method: str = "auto",
        spec: Optional[T.ResultSpec] = None,
        trace: bool = False,
    ) -> list:
        """Execute a batch of queries under a ResultSpec -> per-query typed
        results (sorted id arrays by default).

        Queries are bucketed by access path (the planner's vectorized
        fixpoint when ``method="auto"``, or the explicit method for all) and
        each bucket runs through a single fused multi-query launch carrying
        the spec's on-device reducer — and, under a live delta, the delta
        scan and the tombstone fold in the same counted op. Results are
        positionally aligned with the input and identical to per-query
        ``query`` calls; ``BatchStats`` land in ``last_batch_stats``.

        ``trace=True`` installs an ``obs.Tracer`` for the duration and leaves
        a ``BatchTrace`` in ``last_trace``: one ``QueryTrace`` per query plus
        the span tree. With ``trace=False`` the span calls short-circuit to
        ``obs.NULL_SPAN``.
        """
        state = self._state
        spec = T.resolve_spec(spec)
        batch = _as_batch(queries)
        if batch is None or len(batch) == 0:
            self.last_batch_stats = BatchStats(0, 0.0, {}, 0, methods=[])
            return []
        if batch.m != state.dataset.m:
            raise ValueError(f"batch dims {batch.m} != dataset dims "
                             f"{state.dataset.m}")
        spec.validate(state.dataset.m)
        dview, delta_arg = self._snapshot(state)

        tracer = obs_tracing.Tracer() if trace else None
        if tracer is not None:
            tracer.__enter__()
        try:
            t0 = time.perf_counter()
            bp, methods = self._plan(state, batch, method, spec, dview.d)
            plan_dt = time.perf_counter() - t0
            buckets = self._buckets(methods)
            results: list = [None] * len(batch)
            for meth, idxs in buckets.items():
                sub = T.QueryBatch(batch.lower[idxs], batch.upper[idxs])
                with obs_tracing.span("execute", path=meth,
                                      bucket=len(idxs)) as sp:
                    out = self._path_query_batch(
                        _lookup_path(state.paths, meth), sub, spec,
                        delta=delta_arg)
                    sp.block_on(out)
                for k, res in zip(idxs, out):
                    results[k] = res
            dt = time.perf_counter() - t0
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)

        self._count_served(buckets)
        self.last_batch_stats = BatchStats(
            n_queries=len(batch),
            seconds=dt,
            method_counts={m: len(ix) for m, ix in buckets.items()},
            n_results=_n_results(spec, results),
            plan_seconds=plan_dt,
            methods=list(methods),
        )
        if tracer is not None:
            self.last_trace = self._build_trace(
                state, tracer, batch, spec, bp, methods, buckets, results,
                plan_dt, dt)
        return results

    @staticmethod
    def _build_trace(state, tracer, batch, spec, bp, methods, buckets,
                     results, plan_dt, dt) -> obs_tracing.BatchTrace:
        """Assemble per-query ``QueryTrace`` records from the span tree and
        the batch plan (estimates come from ``bp`` when the planner chose;
        explicit-method runs get histogram selectivities and NaN cost)."""
        n = state.dataset.n
        mq = batch.dims_mask.sum(axis=1)
        if bp is not None:
            sels = bp.est_selectivity
            path_row = {name: j for j, name in enumerate(bp.path_names)}
        else:
            sels = state.planner.plan_inputs(batch).sels
            path_row = {}
        # one execute span per bucket, keyed by its path attr
        bucket_spans = {s.attrs.get("path"): s for s in tracer.find("execute")}
        records = []
        for k, meth in enumerate(methods):
            bsize = len(buckets[meth])
            sp = bucket_spans.get(meth)
            res_size = spec.result_size(results[k])
            obs_sel = (res_size / n if spec.kind in ("ids", "count", "mask")
                       else None)
            est_cost = (float(bp.costs[path_row[meth], k]) if bp is not None
                        else float("nan"))
            records.append(obs_tracing.QueryTrace(
                index=k,
                method=meth,
                bucket_size=bsize,
                est_selectivity=float(sels[k]),
                est_cost=est_cost,
                spec_kind=spec.kind,
                mq=int(mq[k]),
                result_size=res_size,
                obs_selectivity=obs_sel,
                seconds=(sp.seconds / bsize if sp is not None else 0.0),
                launches=(sp.launches / bsize if sp is not None else 0.0),
                host_syncs=(sp.host_syncs / bsize if sp is not None else 0.0),
            ))
        return obs_tracing.BatchTrace(
            n=n, n_queries=len(batch), spec_kind=spec.kind,
            plan_seconds=plan_dt, seconds=dt, queries=records,
            spans=tracer.spans)

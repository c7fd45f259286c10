"""Core datatypes for multidimensional range queries (MDRQ).

The paper's problem definition (§2.1):

  * a dataset ``D`` of ``n`` objects with ``m`` float attributes,
  * a (partial- or complete-match) range query ``q`` with per-dimension
    predicates ``[lb_j, ub_j]``; un-queried dimensions use ``[-inf, +inf]``,
  * a result = the set of identifiers of matching objects.

The device layout is **dimension-major (columnar)**, shape ``(m, n)``: a row
holds one attribute of every object, so a thread block reads neighbouring
objects of one attribute from neighbouring addresses, and the AND over
dimensions happens in registers.

Query containers and oracles are numpy; only the ``ResultSpec`` device
reducers touch torch tensors.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import ClassVar, Optional, Sequence

import numpy as np
import torch

from repro_torch import numerics

NEG_INF = np.float32(-np.inf)
POS_INF = np.float32(np.inf)


# =============================================================================
# ResultSpec — the result protocol
# =============================================================================
# A ``ResultSpec`` names the shape a caller wants back and pairs
#
#   * an **on-device reducer** — applied to the (Q, n_pad) match masks inside
#     the same counted op as the kernel that produced them, so only the
#     reduced payload crosses the device->host boundary, and
#   * a **host finalizer** — turning the fetched payload into one typed
#     result per query,
#
# plus the planner's output-bytes estimate and the per-query host fallback
# (``from_ids``) the generic ``PerQueryPath`` rung uses. Specs are frozen
# (hashable) dataclasses.

RESULT_SPEC_KINDS: dict[str, type] = {}


def register_result_spec(cls):
    """Register a ResultSpec subclass under ``cls.kind`` (decorator)."""
    RESULT_SPEC_KINDS[cls.kind] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class ResultSpec:
    """Base of the result protocol: what a query should return, and how.

    The base class implements the identity reduction (payload = the masks
    themselves), so mask-shaped specs (``Ids``, ``Mask``) need no device code.
    """

    kind: ClassVar[str] = "abstract"
    # True when the payload of a sharded scan stays per shard (Ids, Mask:
    # the shards' masks, concatenated on the host); False when the shards'
    # partials merge on the mesh's first device (Count, TopK, Agg).
    sharded_payload: ClassVar[bool] = False
    # True when ``reduce_visits`` consumes the host-built (Q, M) visit-index
    # table; everyone else gets a (1, 1) placeholder, so the two-phase paths
    # skip building and shipping it.
    needs_visit_index: ClassVar[bool] = False

    @property
    def value_dim(self) -> Optional[int]:
        """Attribute dimension whose values the reducer reads (None = none)."""
        return None

    def validate(self, m: int) -> "ResultSpec":
        """Check the spec against an m-dim dataset (canonical error site)."""
        d = self.value_dim
        if d is not None and not (0 <= d < m):
            raise ValueError(f"{self.kind} dim {d} out of range for m={m}")
        return self

    # -- on-device reducer (called inside the fused counted ops) -----------
    def device_reduce(self, masks: torch.Tensor, data_cm: torch.Tensor, *,
                      tile_n: int, backend: str):
        """(q_pad, n_pad) match masks -> device payload (identity here)."""
        return masks

    def reduce_visits(self, masks: torch.Tensor, data_cm: torch.Tensor, qids,
                      bids, valid, visit_index, *, tile_n: int, n_queries: int,
                      backend: str):
        """(V_pad, tile_n) two-phase visit masks -> device payload."""
        return masks

    def distributed_reduce(self, masks_by_shard, data_by_shard, mesh, *,
                           tile_n: int, backend: str):
        """Per-shard (q_pad, n_local) masks -> payload of a sharded scan
        (``core.distributed``): the identity here, the masks in shard
        order. ``data_by_shard`` holds each shard's (m_pad, n_local) block;
        reducing specs merge their partials on ``mesh.first`` in shard
        order."""
        return tuple(masks_by_shard)

    # -- host finalizers ------------------------------------------------------
    def finalize(self, payload, q_n: int, n: int) -> list:
        """Host payload from the mask-shaped routes -> one result per query."""
        raise NotImplementedError

    def finalize_visits(self, payload, vctx: "VisitHostCtx") -> list:
        """Host payload from the visit-shaped route -> one result per query.

        Defaults to ``finalize`` — right whenever the visit reducer produced
        the mask reducer's payload shape (Count, Agg).
        """
        return self.finalize(payload, vctx.n_queries, vctx.n)

    def from_ids(self, ids: np.ndarray, cols: np.ndarray):
        """Host fallback from a materialized id set (``PerQueryPath`` rung)."""
        raise NotImplementedError

    # -- planner surface ----------------------------------------------------
    def host_bytes(self, touched, n: int):
        """Estimated device->host payload + host-materialization bytes per
        query. ``touched`` is the mask bytes the path would read back in the
        identity reduction; scalar or (Q,) — the return broadcasts with it.
        """
        raise NotImplementedError

    # -- delta merge (the mutable data plane) --------------------------------
    def merge_delta(self, base_results: list, delta_results: list,
                    dctx: "DeltaHostCtx") -> list:
        """Fold per-query delta results into the base results.

        Under a non-empty delta the fused ops evaluate base and delta in one
        counted op and return two payloads; both finalize with the spec's
        ordinary host finalizer (the delta side in *local* delta
        coordinates, objects ``[0, d)``), and this hook combines them into
        one answer per query. A spec without it cannot serve a mutated
        engine — ``compact()`` first.
        """
        raise NotImplementedError(
            f"result spec {self.kind!r} does not implement merge_delta; "
            f"compact() the engine before querying with it")

    # -- misc ---------------------------------------------------------------
    def empty_result(self, n: int):
        """The result of a query with an empty candidate set."""
        raise NotImplementedError

    def result_size(self, res) -> int:
        """Result magnitude for QueryStats/BatchStats ``n_results``."""
        raise NotImplementedError


@register_result_spec
@dataclasses.dataclass(frozen=True)
class Ids(ResultSpec):
    """Sorted matching identifiers — the paper's §2.1 result definition."""

    kind: ClassVar[str] = "ids"
    sharded_payload: ClassVar[bool] = True

    def finalize(self, payload, q_n, n):
        return [np.nonzero(payload[k, :n])[0].astype(np.int64)
                for k in range(q_n)]

    def finalize_visits(self, payload, vctx):
        from repro_torch.core import blockindex  # runtime: no import cycle
        return blockindex.scatter_visit_results(
            payload[: vctx.qids.size], vctx.qids, vctx.bids, vctx.n_queries,
            vctx.tile_n, vctx.n, vctx.perm)

    def from_ids(self, ids, cols):
        return ids

    def merge_delta(self, base_results, delta_results, dctx):
        # Delta ids are all >= n (append order), so concatenation keeps the
        # per-query id arrays sorted.
        return [np.concatenate([b, dctx.delta_ids[np.asarray(d, np.int64)]])
                for b, d in zip(base_results, delta_results)]

    def host_bytes(self, touched, n):
        # the mask readback plus the host-side nonzero sweep over it
        return 2.0 * touched

    def empty_result(self, n):
        return np.empty((0,), np.int64)

    def result_size(self, res):
        return int(res.size)


@register_result_spec
@dataclasses.dataclass(frozen=True)
class Mask(ResultSpec):
    """The raw (n,) bool match mask per query (no id materialization)."""

    kind: ClassVar[str] = "mask"
    sharded_payload: ClassVar[bool] = True

    def finalize(self, payload, q_n, n):
        return [np.asarray(payload[k, :n]) > 0 for k in range(q_n)]

    def finalize_visits(self, payload, vctx):
        from repro_torch.core import blockindex
        out = []
        for ids in blockindex.scatter_visit_results(
                payload[: vctx.qids.size], vctx.qids, vctx.bids,
                vctx.n_queries, vctx.tile_n, vctx.n, vctx.perm):
            m = np.zeros((vctx.n,), bool)
            m[ids] = True
            out.append(m)
        return out

    def from_ids(self, ids, cols):
        m = np.zeros((cols.shape[1],), bool)
        m[ids] = True
        return m

    def merge_delta(self, base_results, delta_results, dctx):
        # The merged mask covers the combined id space [0, n + d).
        out = []
        for b, d in zip(base_results, delta_results):
            m = np.zeros((dctx.n + dctx.delta_ids.size,), bool)
            m[: dctx.n] = b
            m[dctx.n:] = d
            out.append(m)
        return out

    def host_bytes(self, touched, n):
        return touched + float(n)

    def empty_result(self, n):
        return np.zeros((n,), bool)

    def result_size(self, res):
        return int(res.sum())


@register_result_spec
@dataclasses.dataclass(frozen=True)
class Count(ResultSpec):
    """Per-query match counts reduced on device (COUNT(*) fast path)."""

    kind: ClassVar[str] = "count"

    def device_reduce(self, masks, data_cm, *, tile_n, backend):
        return masks.ne(0).sum(dim=-1, dtype=torch.int32)

    def reduce_visits(self, masks, data_cm, qids, bids, valid, visit_index,
                      *, tile_n, n_queries, backend):
        from repro_torch.kernels import reducers
        return reducers.visit_mask_counts(masks, qids, valid, n_queries)

    def distributed_reduce(self, masks_by_shard, data_by_shard, mesh, *,
                           tile_n, backend):
        # shard counts summed on the first device (integer adds: exact)
        parts = mesh.gather([mk.ne(0).sum(dim=-1, dtype=torch.int32)
                             for mk in masks_by_shard])
        return torch.stack(parts).sum(dim=0, dtype=torch.int32)

    def finalize(self, payload, q_n, n):
        return [int(c) for c in np.asarray(payload)[:q_n]]

    def from_ids(self, ids, cols):
        return int(ids.size)

    def merge_delta(self, base_results, delta_results, dctx):
        return [int(b) + int(d) for b, d in zip(base_results, delta_results)]

    def host_bytes(self, touched, n):
        return 4.0 * np.ones_like(np.asarray(touched, np.float64))

    def empty_result(self, n):
        return 0

    def result_size(self, res):
        return int(res)


@register_result_spec
@dataclasses.dataclass(frozen=True)
class TopK(ResultSpec):
    """Top-k matching ids ordered by attribute ``dim`` (k-largest/smallest).

    The reducer fills non-matching lanes with the identity, selects the k
    extremes on device, and ships only (k values, k positions, 1 count) per
    query; the finalizer truncates to the true match count. Ties order by
    ascending position, exactly as the reference's device ``top_k`` does:
    by id on the scans, by permuted (leaf-order) position on the trees,
    whose finalizer then maps positions through the permutation.
    """

    kind: ClassVar[str] = "topk"
    needs_visit_index: ClassVar[bool] = True
    k: int = 1
    dim: int = 0
    largest: bool = True

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"TopK k must be >= 1, got {self.k}")

    @property
    def value_dim(self):
        return self.dim

    def device_reduce(self, masks, data_cm, *, tile_n, backend):
        from repro_torch.kernels import reducers
        return reducers.masked_topk(masks, data_cm[self.dim], self.k,
                                    self.largest, tile_n=tile_n,
                                    backend=backend)

    def reduce_visits(self, masks, data_cm, qids, bids, valid, visit_index,
                      *, tile_n, n_queries, backend):
        from repro_torch.kernels import reducers
        vals, pos = reducers.visit_topk(masks, data_cm, self.dim, bids, valid,
                                        visit_index, self.k, self.largest,
                                        tile_n)
        counts = reducers.visit_mask_counts(masks, qids, valid, n_queries)
        return vals, pos, counts

    def distributed_reduce(self, masks_by_shard, data_by_shard, mesh, *,
                           tile_n, backend):
        # Each shard's top-k (the fill kernel, then the composite-key
        # top-k), then one top-k over the (Q, D * k) candidates on the first
        # device: positions offset by s * n_local, ties by ascending global
        # position, lanes past a shard's match count cut.
        from repro_torch.kernels import reducers
        parts = [reducers.masked_topk(mk, x[self.dim], self.k, self.largest,
                                      tile_n=tile_n, backend=backend)
                 for mk, x in zip(masks_by_shard, data_by_shard)]
        return reducers.merge_shard_topk(
            [mesh.gather(p) for p in parts], data_by_shard[0].shape[-1],
            self.k, self.largest)

    def finalize(self, payload, q_n, n):
        _, idx, counts = payload
        out = []
        for k in range(q_n):
            c = min(int(counts[k]), idx.shape[1], self.k)
            out.append(np.asarray(idx[k, :c]).astype(np.int64))
        return out

    def finalize_visits(self, payload, vctx):
        _, pos, counts = payload
        out = []
        for k in range(vctx.n_queries):
            c = min(int(counts[k]), pos.shape[1], self.k)
            p = np.asarray(pos[k, :c]).astype(np.int64)
            out.append(vctx.perm[p] if vctx.perm is not None else p)
        return out

    def from_ids(self, ids, cols):
        vals = cols[self.dim, ids]
        order = np.argsort(-vals if self.largest else vals, kind="stable")
        return ids[order[: self.k]].astype(np.int64)

    def merge_delta(self, base_results, delta_results, dctx):
        # Exact: top-k of (base ∪ delta) ⊆ (top-k of base) ∪ (top-k of
        # delta), so re-ranking the <= 2k candidates by a host value gather
        # gives the answer. Ties order by ascending id, so a delta id
        # (n + j) follows every base id of equal value — as the reference
        # merges.
        out = []
        for b, d in zip(base_results, delta_results):
            cand = np.concatenate([np.asarray(b, np.int64),
                                   dctx.delta_ids[np.asarray(d, np.int64)]])
            if cand.size == 0:
                out.append(cand)
                continue
            vals = np.where(
                cand < dctx.n,
                dctx.base_cols[self.dim, np.minimum(cand, dctx.n - 1)],
                dctx.delta_rows[np.maximum(cand - dctx.n, 0), self.dim])
            order = np.lexsort((cand, -vals if self.largest else vals))
            out.append(cand[order[: self.k]].astype(np.int64))
        return out

    def host_bytes(self, touched, n):
        return (12.0 * self.k + 4.0) \
            * np.ones_like(np.asarray(touched, np.float64))

    def empty_result(self, n):
        return np.empty((0,), np.int64)

    def result_size(self, res):
        return int(res.size)


@register_result_spec
@dataclasses.dataclass(frozen=True)
class Agg(ResultSpec):
    """A per-query aggregate (min | max | sum) of attribute ``dim`` over the
    matching set. Empty matches finalize to 0.0 (sum) or NaN (min/max).

    On the two-phase paths the per-visit partials reduce per query through
    the visit-index table (the reference adds them with a segment scatter,
    which on the card would take float atomics), so this spec needs it too.
    """

    kind: ClassVar[str] = "agg"
    needs_visit_index: ClassVar[bool] = True
    op: str = "sum"
    dim: int = 0

    OPS: ClassVar[tuple[str, ...]] = ("min", "max", "sum")

    def __post_init__(self):
        if self.op not in self.OPS:
            raise ValueError(f"unknown agg op {self.op!r}; options: {self.OPS}")

    @property
    def value_dim(self):
        return self.dim

    def device_reduce(self, masks, data_cm, *, tile_n, backend):
        from repro_torch.kernels import reducers
        return reducers.masked_agg(masks, data_cm[self.dim], self.op,
                                   tile_n=tile_n, backend=backend)

    def reduce_visits(self, masks, data_cm, qids, bids, valid, visit_index,
                      *, tile_n, n_queries, backend):
        from repro_torch.kernels import reducers
        agg = reducers.visit_agg(masks, data_cm, self.dim, bids, valid,
                                 visit_index, self.op, tile_n)
        counts = reducers.visit_mask_counts(masks, qids, valid, n_queries)
        return agg, counts

    def distributed_reduce(self, masks_by_shard, data_by_shard, mesh, *,
                           tile_n, backend):
        # Shard-local aggregates (the agg kernel), merged on the first
        # device in shard order: a fixed order, so repeated sums are
        # bit-identical (the sum's order differs from one device's).
        from repro_torch.kernels import reducers
        parts = [reducers.masked_agg(mk, x[self.dim], self.op, tile_n=tile_n,
                                     backend=backend)
                 for mk, x in zip(masks_by_shard, data_by_shard)]
        aggs = torch.stack(mesh.gather([a for a, _ in parts]))
        counts = torch.stack(mesh.gather([c for _, c in parts]))
        merged = {"sum": aggs.sum, "min": aggs.amin,
                  "max": aggs.amax}[self.op](dim=0)
        return merged, counts.sum(dim=0, dtype=torch.int32)

    def finalize(self, payload, q_n, n):
        agg, counts = payload
        out = []
        for k in range(q_n):
            if int(counts[k]) == 0:
                out.append(self.empty_result(n))
            else:
                out.append(float(agg[k]))
        return out

    def from_ids(self, ids, cols):
        if ids.size == 0:
            return self.empty_result(cols.shape[1])
        vals = cols[self.dim, ids]
        if self.op == "sum":
            # float32 accumulation, matching the device reducer's dtype
            return float(np.sum(vals, dtype=np.float32))
        return float({"min": np.min, "max": np.max}[self.op](vals))

    def merge_delta(self, base_results, delta_results, dctx):
        # NaN marks an empty match set on min/max (the finalizer's empty
        # sentinel), so the combine is NaN-aware; sums add directly (an
        # empty side contributes the 0.0 identity).
        out = []
        for b, d in zip(base_results, delta_results):
            if self.op == "sum":
                out.append(float(b) + float(d))
            elif np.isnan(b):
                out.append(float(d))
            elif np.isnan(d):
                out.append(float(b))
            else:
                out.append(float({"min": min, "max": max}[self.op](b, d)))
        return out

    def host_bytes(self, touched, n):
        return 12.0 * np.ones_like(np.asarray(touched, np.float64))

    def empty_result(self, n):
        return 0.0 if self.op == "sum" else float("nan")

    def result_size(self, res):
        return 1


# Shared default instances.
IDS = Ids()
COUNT = Count()


@dataclasses.dataclass(frozen=True)
class VisitHostCtx:
    """Host-side context ``finalize_visits`` needs to map a visit-shaped
    payload back to per-query results (two-phase paths only)."""

    qids: np.ndarray            # (V,) int32 query id per real visit
    bids: np.ndarray            # (V,) int32 block id per real visit
    tile_n: int
    n: int                      # logical object count
    n_queries: int
    perm: Optional[np.ndarray]  # position -> original id (None = identity)


@dataclasses.dataclass(frozen=True)
class DeltaHostCtx:
    """Host-side context ``ResultSpec.merge_delta`` needs to fold per-query
    delta results (local delta coordinates) into base results (original
    ids). Built by ``core.delta.DeltaView.host_ctx``; the value arrays back
    the TopK re-rank's host gather."""

    n: int                      # base object count — delta ids start here
    delta_ids: np.ndarray       # (d,) int64 global ids of the delta rows
    base_cols: np.ndarray       # (m, n) base columns
    delta_rows: np.ndarray      # (d, m) delta rows


# The deprecated ``mode=`` strings the server still takes, and their specs.
RESULT_MODES = ("ids", "count")
_MODE_SPECS: dict[str, ResultSpec] = {"ids": IDS, "count": COUNT}


def resolve_spec(spec: Optional[ResultSpec] = None,
                 mode: Optional[str] = None) -> ResultSpec:
    """The spec argument of the public entry points: ``None`` means
    ``Ids()``; anything that is not a ``ResultSpec`` is rejected.

    ``mode`` is the deprecated string alias (``"ids"`` / ``"count"``) of the
    server's signature: it maps to ``Ids()`` / ``Count()`` with a
    ``DeprecationWarning``; passing both is an error (ambiguous intent).
    """
    if mode is not None:
        if spec is not None:
            raise ValueError("pass spec= or the deprecated mode=, not both")
        if mode not in _MODE_SPECS:
            raise ValueError(f"unknown mode {mode!r}; options: {RESULT_MODES} "
                             f"or a types.ResultSpec")
        warnings.warn(
            f"mode={mode!r} strings are deprecated; pass a ResultSpec "
            f"(types.{_MODE_SPECS[mode].kind.capitalize()}()) instead",
            DeprecationWarning, stacklevel=3)
        return _MODE_SPECS[mode]
    if spec is None:
        return IDS
    if isinstance(spec, ResultSpec):
        return spec
    raise ValueError(f"unknown result spec {spec!r}; pass a types.ResultSpec "
                     f"({', '.join(sorted(RESULT_SPEC_KINDS))})")


@dataclasses.dataclass(frozen=True)
class RangeQuery:
    """A multidimensional range query (complete- or partial-match).

    ``lower``/``upper`` always have length ``m``; dimensions not mentioned in
    the query carry ``[-inf, +inf]`` (paper §2.1). ``dims_mask`` records which
    dimensions are actually constrained.
    """

    lower: np.ndarray  # (m,) float32
    upper: np.ndarray  # (m,) float32

    def __post_init__(self):
        lo = np.asarray(self.lower, dtype=np.float32)
        up = np.asarray(self.upper, dtype=np.float32)
        if lo.shape != up.shape or lo.ndim != 1:
            raise ValueError(f"bad query bounds: {lo.shape} vs {up.shape}")
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", up)

    @property
    def m(self) -> int:
        return self.lower.shape[0]

    @property
    def dims_mask(self) -> np.ndarray:
        """(m,) bool — True where the dimension is actually constrained."""
        return ~(np.isneginf(self.lower) & np.isposinf(self.upper))

    @property
    def n_queried_dims(self) -> int:
        return int(self.dims_mask.sum())

    @property
    def is_complete_match(self) -> bool:
        return bool(self.dims_mask.all())

    @staticmethod
    def complete(lower: Sequence[float], upper: Sequence[float]) -> "RangeQuery":
        return RangeQuery(np.asarray(lower, np.float32), np.asarray(upper, np.float32))

    @staticmethod
    def partial(m: int, predicates: dict[int, tuple[float, float]]) -> "RangeQuery":
        """Partial-match query: ``{dim: (lb, ub)}`` over an m-dim space."""
        lo = np.full((m,), NEG_INF, np.float32)
        up = np.full((m,), POS_INF, np.float32)
        for j, (a, b) in predicates.items():
            lo[j], up[j] = np.float32(a), np.float32(b)
        return RangeQuery(lo, up)


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """An ordered batch of range queries over the same m-dim space.

    Bounds are stacked (Q, m) so the kernels' query-minor (m_pad, Q) layout
    and the per-query constrained-dim lists derive without touching each
    query again.
    """

    lower: np.ndarray  # (Q, m) float32
    upper: np.ndarray  # (Q, m) float32

    def __post_init__(self):
        lo = np.asarray(self.lower, dtype=np.float32)
        up = np.asarray(self.upper, dtype=np.float32)
        if lo.shape != up.shape or lo.ndim != 2:
            raise ValueError(f"bad batch bounds: {lo.shape} vs {up.shape}")
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", up)

    @staticmethod
    def from_queries(queries: Sequence["RangeQuery"]) -> "QueryBatch":
        if not queries:
            raise ValueError("empty query batch")
        m = queries[0].m
        for q in queries:
            if q.m != m:
                raise ValueError(f"mixed dims in batch: {q.m} != {m}")
        return QueryBatch(np.stack([q.lower for q in queries]),
                          np.stack([q.upper for q in queries]))

    def __len__(self) -> int:
        return self.lower.shape[0]

    def __getitem__(self, k: int) -> "RangeQuery":
        return RangeQuery(self.lower[k], self.upper[k])

    @property
    def m(self) -> int:
        return self.lower.shape[1]

    @property
    def dims_mask(self) -> np.ndarray:
        """(Q, m) bool — True where a dimension is actually constrained."""
        return ~(np.isneginf(self.lower) & np.isposinf(self.upper))

    def bounds_columnar(self, m_pad: int, q_pad: int | None = None,
                        dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
        """Query-minor (m_pad, q_pad or Q) finite bounds for the fused kernels.

        Padding dims (and unconstrained dims) carry the extrema of ``dtype``
        (the dtype the device comparison runs in), i.e. match-all against any
        finite value; padding *queries* (columns beyond Q, rounding the batch
        to a pow2 bucket) are match-all too — callers drop their output rows.
        """
        q_n = q_pad or len(self)
        lo = np.full((m_pad, q_n), NEG_INF, np.float32)
        up = np.full((m_pad, q_n), POS_INF, np.float32)
        lo[: self.m, : len(self)] = self.lower.T
        up[: self.m, : len(self)] = self.upper.T
        return finite_query_bounds(lo, up, dtype=dtype)

    def padded_dim_ids(self, q_pad: int | None = None) -> np.ndarray:
        """(q_pad or Q, D_max) int32 constrained-dim ids for the batched
        vertical scan.

        Shorter rows pad by repeating the query's own last constrained dim
        (AND is idempotent); a fully unconstrained query — and any padding
        query row — uses dim 0, whose bounds column is match-all. D_max
        rounds to a pow2 to bound the set of launch shapes.
        """
        mask = self.dims_mask
        d_max = next_pow2(max(1, int(mask.sum(axis=1).max(initial=0))))
        ids = np.zeros((q_pad or len(self), d_max), np.int32)
        for k in range(len(self)):
            d = np.nonzero(mask[k])[0].astype(np.int32)
            if d.size == 0:
                d = np.zeros((1,), np.int32)
            ids[k] = np.pad(d, (0, d_max - d.size), mode="edge")
        return ids


@dataclasses.dataclass
class Dataset:
    """A columnar in-memory dataset: ``cols[j, i]`` = attribute j of object i.

    ``rows()`` gives the row-major view (the paper's horizontal layout)."""

    cols: np.ndarray  # (m, n) float32

    def __post_init__(self):
        c = np.asarray(self.cols)
        if c.ndim != 2:
            raise ValueError(f"cols must be (m, n), got {c.shape}")
        self.cols = np.ascontiguousarray(c, dtype=np.float32)

    @property
    def m(self) -> int:
        return self.cols.shape[0]

    @property
    def n(self) -> int:
        return self.cols.shape[1]

    @property
    def nbytes(self) -> int:
        return self.cols.nbytes

    def rows(self) -> np.ndarray:
        """(n, m) row-major copy of the data."""
        return np.ascontiguousarray(self.cols.T)


def match_mask_np(cols: np.ndarray, q: RangeQuery) -> np.ndarray:
    """Numpy oracle: (n,) bool mask of objects matching q. O(n·m)."""
    lo = q.lower[:, None]
    up = q.upper[:, None]
    return np.logical_and(cols >= lo, cols <= up).all(axis=0)


def match_ids_np(cols: np.ndarray, q: RangeQuery) -> np.ndarray:
    """Numpy oracle: sorted identifiers of matching objects."""
    return np.nonzero(match_mask_np(cols, q))[0].astype(np.int64)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (pow2 buckets bound the launch shapes)."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def pad_axis(x: np.ndarray, axis: int, multiple: int, value) -> np.ndarray:
    """Pad ``axis`` of x up to the next multiple of ``multiple`` with value."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths, constant_values=value)


def padded_query_bounds(
    q: RangeQuery, m_padded: int
) -> tuple[np.ndarray, np.ndarray]:
    """Query bounds padded to ``m_padded`` dims with [-inf, +inf] (match-all)."""
    lo = np.full((m_padded,), NEG_INF, np.float32)
    up = np.full((m_padded,), POS_INF, np.float32)
    lo[: q.m] = q.lower
    up[: q.m] = q.upper
    return lo, up


def finite_query_bounds(lo: np.ndarray, up: np.ndarray, dtype=np.float32):
    """Replace +-inf with the *target device dtype's* finite extrema.

    ``dtype`` must be the dtype the comparison actually runs in: substituting
    float32 extrema under a bfloat16 cast rounds ``finfo(f32).max`` back to
    ``+inf``, so the +inf object-padding sentinels would *match* and every
    padded-axis count would overcount. Extrema are additionally clamped into
    float32's finite range because these carrier arrays are float32.
    """
    neg = max(numerics.finite_min(dtype), numerics.finite_min(np.float32))
    pos = min(numerics.finite_max(dtype), numerics.finite_max(np.float32))
    lo = np.where(np.isneginf(lo), neg, lo).astype(np.float32)
    up = np.where(np.isposinf(up), pos, up).astype(np.float32)
    return lo, up

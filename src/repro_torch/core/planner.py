"""Access-path planner: the paper's break-even rule as an operational cost model.

The paper's headline result is that the scan-vs-index break-even selectivity
drops from the classical 15-20% to ~1% on modern hardware (§8). Here that
conclusion becomes machinery: per-dimension equi-width histograms estimate
query selectivity (independence assumption, §2.1 — the paper notes it fails
for correlated dims, so estimates are clamped and calibration is exposed), and
an analytic byte-cost model ranks the available access paths.

Cost model (napkin terms, all in bytes moved + per-dispatch overhead):

  scan_full      : n * m * B
  scan_vertical  : n * m_q * B                      (partial match, §5.5)
  kdtree / rstar : nodes * m * 2B  +  f_leaf * n * m * B / visit_discount  + sync
  vafile         : n * ceil(m/16) * 4  +  f_blk * n * m * B / visit_discount + sync

with ``f_leaf ~= prod_over_queried (s^(1/m_q) + l)``, ``l = (tile/n)^(1/m)``
(query box side + leaf box side per dim) and the VA candidate fraction
``prod (s_j + 2/CELLS)``.

The two index-specific taxes model the random-access penalty: two-phase
execution needs a device->host->device round trip (``host_sync_overhead``) to
turn the prune mask into a visit list, and scattered tile reads run below
streaming bandwidth (``visit_bw_discount``). ``calibrate()`` fits the machine
constants from measured runs.

The machine constants here are **uncalibrated placeholders**: they hold the
reference package's values (its TPU v5e roofline units) so that the port
plans exactly as the reference does for the same inputs. They are not the
H100's; refitting them from H100 runs is later work.

Batched execution: every cost accepts a ``batch`` size — the number of
queries fused into one launch (``MDRQEngine.query_batch``). Fixed taxes
(dispatch, host sync) divide by the batch, and the fused scans' streamed
bytes amortize down to a compute floor (``sec_per_cmp``). The two effects
pull the scan-vs-index break-even in *opposite* directions, and
``break_even_selectivity(batch_size=...)`` reports the net — a result the
paper's single-query analysis cannot express.

Batch planning is vectorized and runs to a fixpoint (DESIGN.md §7): one numpy
pass over the (Q, 2, m) bounds estimates every query's selectivity
(``Histograms.selectivity_batch``), each registered access path prices all Q
queries at once (``AccessPath.cost_batch`` -> a (paths x Q) cost matrix), and
``plan_batch`` iterates plan -> bucket -> replan so the amortization uses the
*realized* per-bucket sizes — not the whole-batch approximation — converging
in 2-3 rounds because every amortized term is monotone in bucket size.
Planning cost no longer grows Python-linearly with Q.

The planner itself is access-path-agnostic: it ranks whatever path objects it
holds (the engine's registry, or structure-free stubs when built from names
for cost-model studies). Path-specific formulas live in the ``CostModel``
methods the ``core.paths`` cost mixins delegate to.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core import types as T
from repro_torch.core import paths as paths_mod

# The VA-file's cell resolution and packing density: the planning slack
# (2/CELLS per dim) and the approximation bytes (ceil(m / DIMS_PER_WORD)
# words) derive from the same constants the build and the kernel use, so a
# cell-resolution change can never silently skew the plan vs the execution.
from repro_torch.core.vafile import CELLS as VA_CELLS
from repro_torch.kernels.va_filter import DIMS_PER_WORD as VA_DIMS_PER_WORD

# Machine-constant defaults of ``CostModel`` — UNCALIBRATED PLACEHOLDERS in
# the reference's TPU v5e roofline units (seconds), carried over unchanged so
# the port's plans equal the reference's for the same constants. They do not
# describe the H100.
PLACEHOLDER_SEC_PER_BYTE = 1.0 / 819e9
PLACEHOLDER_DISPATCH_OVERHEAD = 2e-6
PLACEHOLDER_HOST_SYNC_OVERHEAD = 20e-6
PLACEHOLDER_VISIT_BW_DISCOUNT = 0.6
PLACEHOLDER_SEC_PER_CMP = 2.5e-13
PLACEHOLDER_COLLECTIVE_OVERHEAD = 5e-6
PLACEHOLDER_SEC_PER_RESULT_BYTE = 1.0 / 16e9

BINS = 64


@dataclasses.dataclass
class Histograms:
    """Per-dimension equi-width histograms for selectivity estimation."""

    edges: np.ndarray   # (m, BINS + 1)
    counts: np.ndarray  # (m, BINS)
    n: int

    @staticmethod
    def build(dataset: T.Dataset, bins: int = BINS) -> "Histograms":
        m, n = dataset.m, dataset.n
        edges = np.empty((m, bins + 1), np.float64)
        counts = np.empty((m, bins), np.float64)
        for d in range(m):
            c, e = np.histogram(dataset.cols[d], bins=bins)
            edges[d], counts[d] = e, c
        return Histograms(edges=edges, counts=counts, n=n)

    def dim_selectivity(self, d: int, lb: float, ub: float) -> float:
        """Estimated fraction of objects with attribute d in [lb, ub].

        Any predicate overlapping the observed domain is clamped to at least
        ``1/n`` — including *point* predicates (``lb == ub``, ubiquitous in
        GMRQB mixed workloads), whose bin coverage is zero-width and would
        otherwise estimate 0.0 and mis-rank every access path.
        """
        if np.isneginf(lb) and np.isposinf(ub):
            return 1.0
        if ub < lb:
            return 0.0  # empty range
        e, c = self.edges[d], self.counts[d]
        if ub < e[0] or lb > e[-1]:
            return 0.0  # disjoint from the observed domain
        lo = np.clip(lb, e[0], e[-1])
        hi = np.clip(ub, e[0], e[-1])
        widths = np.diff(e)
        # fraction of each bin covered by [lo, hi]
        cover = np.clip((np.minimum(hi, e[1:]) - np.maximum(lo, e[:-1])) / np.maximum(widths, 1e-30), 0.0, 1.0)
        frac = float((c * cover).sum() / max(self.n, 1))
        return min(1.0, max(frac, 1.0 / max(self.n, 1)))

    def selectivity(self, q: T.RangeQuery) -> float:
        """Independence-assumption estimate of query selectivity (§2.1).

        Floored at ``1/n`` unless some dimension is provably disjoint from
        the domain: an estimate of "at least one match" is the standard
        planner convention, and it keeps point queries rankable.
        """
        s = 1.0
        for d in np.nonzero(q.dims_mask)[0]:
            s *= self.dim_selectivity(int(d), float(q.lower[d]), float(q.upper[d]))
            if s == 0.0:
                return 0.0
        return max(s, 1.0 / max(self.n, 1))

    # -- vectorized estimation (batch planning) ----------------------------
    def dim_selectivity_batch(self, lower: np.ndarray, upper: np.ndarray
                              ) -> np.ndarray:
        """(Q, m) per-dimension selectivities in one numpy pass.

        Vectorizes ``dim_selectivity`` over queries *and* dimensions — the
        (Q, 2, m) bounds broadcast against the (m, BINS) histograms, so batch
        planning never loops per query per dim in Python. Values match the
        scalar method exactly per (query, dim), including the special cases:
        unconstrained dims (1.0), empty ranges and predicates disjoint from
        the observed domain (0.0), and the in-domain >= 1/n clamp that keeps
        point predicates rankable.
        """
        lo_q = np.asarray(lower, np.float64)
        up_q = np.asarray(upper, np.float64)
        e, c = self.edges, self.counts                     # (m, B+1), (m, B)
        e_lo, e_hi = e[:, 0], e[:, -1]                     # (m,)
        lo = np.clip(lo_q, e_lo, e_hi)                     # (Q, m)
        hi = np.clip(up_q, e_lo, e_hi)
        widths = np.maximum(np.diff(e, axis=1), 1e-30)     # (m, B)
        # fraction of each bin covered by [lo, hi] -> (Q, m, B)
        cover = np.clip(
            (np.minimum(hi[:, :, None], e[None, :, 1:])
             - np.maximum(lo[:, :, None], e[None, :, :-1])) / widths[None],
            0.0, 1.0)
        frac = (c[None] * cover).sum(axis=2) / max(self.n, 1)
        sel = np.minimum(1.0, np.maximum(frac, 1.0 / max(self.n, 1)))
        unconstrained = np.isneginf(lo_q) & np.isposinf(up_q)
        dead = (up_q < lo_q) | (up_q < e_lo) | (lo_q > e_hi)
        return np.where(unconstrained, 1.0, np.where(dead, 0.0, sel))

    def selectivity_batch(self, lower: np.ndarray, upper: np.ndarray,
                          dim_sels: Optional[np.ndarray] = None) -> np.ndarray:
        """(Q,) independence-assumption selectivities for a whole batch.

        One vectorized pass over the (Q, 2, m) bounds; per query the value is
        identical to scalar ``selectivity`` (pass ``dim_sels`` to reuse an
        existing ``dim_selectivity_batch`` result). The scalar method early-
        exits with 0.0 the moment a running product hits zero — a provably
        disjoint dim, or float underflow — and otherwise floors the final
        product at 1/n; the prefix-product check reproduces both exactly
        (unconstrained dims contribute an exact 1.0 factor, so interleaving
        them does not perturb the product).
        """
        if dim_sels is None:
            dim_sels = self.dim_selectivity_batch(lower, upper)
        prefix = np.cumprod(dim_sels, axis=1)
        dead = (prefix == 0.0).any(axis=1)
        return np.where(dead, 0.0,
                        np.maximum(prefix[:, -1], 1.0 / max(self.n, 1)))


@dataclasses.dataclass
class CostModel:
    """Analytic access-path cost model with calibratable machine constants."""

    n: int
    m: int
    tile_n: int = 1024
    bytes_per_val: int = 4
    # Devices the scan shards over (horizontal partitioning, §3.1 — the
    # paper's thread count t mapped to a mesh). Streamed bytes and the
    # compute floor both divide by it; indexes stay single-device.
    n_devices: int = 1
    # machine constants — uncalibrated placeholders (see above); calibrate()
    # refits sec_per_byte and dispatch_overhead.
    sec_per_byte: float = PLACEHOLDER_SEC_PER_BYTE
    dispatch_overhead: float = PLACEHOLDER_DISPATCH_OVERHEAD
    host_sync_overhead: float = PLACEHOLDER_HOST_SYNC_OVERHEAD  # visit-list turn
    visit_bw_discount: float = PLACEHOLDER_VISIT_BW_DISCOUNT    # scattered reads
    sec_per_cmp: float = PLACEHOLDER_SEC_PER_CMP    # compare+AND per element
    collective_overhead: float = PLACEHOLDER_COLLECTIVE_OVERHEAD  # per-launch
    # Device->host payload + host-materialization rate: what the ResultSpec
    # layer's output-bytes term multiplies. Reduced specs (count / top-k /
    # aggregate) read back O(1)-O(k) bytes per query where Ids/Mask read back
    # the whole mask — this term makes ``plan_batch`` spec-dependent.
    sec_per_result_byte: float = PLACEHOLDER_SEC_PER_RESULT_BYTE
    # Live delta-segment rows layered over the frozen structures (DESIGN.md
    # §11). Every path's batch launch additionally scans the delta block, so
    # every cost picks up the same per-*launch* delta term — amortized over
    # the path's realized bucket. That amortization is what flips plans as
    # the delta grows: a minority-bucket index pick pays the delta scan over
    # a few queries where the big scan bucket splits it Q ways. The engine
    # refreshes this from the delta snapshot before each plan.
    delta_n: int = 0

    def _bytes_cost(self, nbytes: float, dispatches: float = 1.0,
                    batch: int = 1) -> float:
        return (nbytes * self.sec_per_byte
                + dispatches * self.dispatch_overhead / max(batch, 1))

    # -- delta-segment term (shared by every path cost) --------------------
    def _delta_cost(self, batch: int = 1) -> float:
        """Per-query seconds for the delta-block scan a batch launch folds
        in: streamed bytes amortize over the fused batch, the per-query
        compare floor does not (same shape as ``_scan_cost``)."""
        if self.delta_n <= 0:
            return 0.0
        elems = float(self.delta_n) * self.m
        stream = elems * self.bytes_per_val * self.sec_per_byte / max(batch, 1)
        return max(stream, elems * self.sec_per_cmp)

    def _delta_cost_batch(self, bucket: np.ndarray) -> np.ndarray:
        b = np.maximum(np.asarray(bucket, np.float64), 1.0)
        if self.delta_n <= 0:
            return np.zeros_like(b)
        elems = float(self.delta_n) * self.m
        stream = elems * self.bytes_per_val * self.sec_per_byte / b
        return np.maximum(stream, elems * self.sec_per_cmp)

    def spec_host_cost(self, spec, touched):
        """Result-payload seconds for ``spec`` on a path whose identity
        (mask) readback would be ``touched`` bytes (scalar or (Q,) array).

        ``spec=None`` prices the pure kernel side (the pre-spec cost surface
        — ``break_even_selectivity`` defaults to it so the recorded
        batch/device break-even tables stay comparable across PRs).
        """
        if spec is None:
            return np.zeros_like(np.asarray(touched, np.float64)) \
                if isinstance(touched, np.ndarray) else 0.0
        return spec.host_bytes(touched, self.n) * self.sec_per_result_byte

    def leaf_side(self) -> float:
        return (self.tile_n / max(self.n, 1)) ** (1.0 / max(self.m, 1))

    def est_leaf_frac(self, q: T.RangeQuery, sel: float) -> float:
        """Fraction of clustered leaves intersecting the query box."""
        mq = max(q.n_queried_dims, 1)
        side = sel ** (1.0 / mq)
        l = self.leaf_side()
        return float(min(1.0, (side + l) ** mq))

    def est_va_candidate_frac(self, q: T.RangeQuery, hist: Histograms) -> float:
        # Per queried dim the candidate cells overrun the query box by at most
        # one cell on each side: slack = 2/CELLS of the domain — derived from
        # the build's actual cell resolution, never hardcoded.
        f = 1.0
        for d in np.nonzero(q.dims_mask)[0]:
            s = hist.dim_selectivity(int(d), float(q.lower[d]), float(q.upper[d]))
            f *= min(1.0, s + 2.0 / VA_CELLS)
        return f

    # -- per-path costs ----------------------------------------------------
    # Every cost is *per query*; ``batch`` is the number of queries fused into
    # the same launch. Batched execution changes the cost structure two ways:
    # fixed taxes (dispatch, host sync) divide by the batch size, and the
    # fused scans re-use each data tile for all queries of the batch, so
    # streamed bytes also divide by the batch — down to the compute floor
    # (``sec_per_cmp``), at which point the fused scan is compute-bound.
    def _scan_cost(self, elems: float, batch: int, n_devices: int | None) -> float:
        """Shared scan cost shape: streamed bytes (amortized over the fused
        batch, sharded over devices) floored by the per-device compute
        rate, plus the per-launch taxes. Multi-device launches additionally
        pay one collective (multi-device dispatch + count all-reduce) per launch —
        also amortized over the batch."""
        d = max(n_devices if n_devices is not None else self.n_devices, 1)
        local = elems / d
        stream = local * self.bytes_per_val * self.sec_per_byte / max(batch, 1)
        cost = max(stream, local * self.sec_per_cmp) \
            + self.dispatch_overhead / max(batch, 1)
        if d > 1:
            cost += self.collective_overhead / max(batch, 1)
        return cost

    def cost_scan(self, q: T.RangeQuery, batch: int = 1,
                  n_devices: int | None = None, spec=None) -> float:
        return self._scan_cost(self.n * self.m, batch, n_devices) \
            + self._delta_cost(batch) \
            + self.spec_host_cost(spec, float(self.n))

    def cost_scan_vertical(self, q: T.RangeQuery, batch: int = 1,
                           n_devices: int | None = None, spec=None) -> float:
        # The distributed path implements only the full fused scan, so the
        # vertical scan executes on one device regardless of the mesh —
        # default to 1 here (not ``self.n_devices``) so the planner's cost
        # matches what actually runs; pass n_devices for what-if analysis.
        mq = max(q.n_queried_dims, 1)
        return self._scan_cost(self.n * mq, batch,
                               n_devices if n_devices is not None else 1) \
            + self._delta_cost(batch) \
            + self.spec_host_cost(spec, float(self.n))

    def cost_tree(self, q: T.RangeQuery, sel: float, batch: int = 1,
                  spec=None) -> float:
        n_leaves = -(-self.n // self.tile_n)
        # Batched prune reads the MBR hierarchy once per batch.
        prune = 2 * n_leaves * self.m * self.bytes_per_val / max(batch, 1)
        f = self.est_leaf_frac(q, sel)
        # Refinement visits are per query (each query has its own leaf list).
        refine = f * self.n * self.m * self.bytes_per_val / self.visit_bw_discount
        return self._bytes_cost(prune + refine, dispatches=2.0, batch=batch) \
            + self.host_sync_overhead / max(batch, 1) \
            + self._delta_cost(batch) \
            + self.spec_host_cost(spec, f * self.n)

    def cost_vafile(self, q: T.RangeQuery, hist: Histograms, batch: int = 1,
                    spec=None) -> float:
        words = -(-self.m // VA_DIMS_PER_WORD)  # packing density of the kernel
        # Both phases are fused per batch (``multi_va_filter`` +
        # ``multi_range_scan_visit``): the packed words stream from HBM once
        # per *batch* — down to the unpack-compare floor — and both sync
        # halves (the phase-1 survivor-bit readback, now one (Q, n_blocks)
        # array, and the visit-mask readback) divide by the batch, as do the
        # two launches' dispatches. At batch=1 this is the single-query
        # two-phase cost structure.
        approx_bytes = self.n * words * 4
        approx = max(approx_bytes * self.sec_per_byte / max(batch, 1),
                     self.n * self.m * self.sec_per_cmp)
        cand = self.est_va_candidate_frac(q, hist)
        blk_frac = 1.0 - (1.0 - min(cand, 1.0)) ** self.tile_n
        refine = blk_frac * self.n * self.m * self.bytes_per_val / self.visit_bw_discount
        return approx + refine * self.sec_per_byte \
            + 2.0 * self.dispatch_overhead / max(batch, 1) \
            + self.host_sync_overhead / max(batch, 1) \
            + self._delta_cost(batch) \
            + self.spec_host_cost(spec, blk_frac * self.n)

    def modeled_bytes(self, method: str, sel: float, mq: int, bucket: int
                      ) -> Optional[float]:
        """Per-query bytes this model says ``method`` moves — the abscissa
        of ``calibrate``'s lstsq fit, computed from a trace's (selectivity,
        constrained dims, realized bucket) so production ``QueryTrace``
        records can feed calibration (``obs.audit.calibration_samples``).

        Mirrors the byte terms of the ``cost_*`` formulas (streamed bytes
        amortized over the fused bucket, refinement bytes under the visit
        bandwidth discount); per-launch taxes are what the fit's intercept
        absorbs. Returns None for paths without a byte model (a registered
        third-party path prices itself; it can calibrate itself too).
        """
        b = max(int(bucket), 1)
        mq = max(int(mq), 1)
        sel = min(max(float(sel), 1.0 / max(self.n, 1)), 1.0)
        # every batch launch also streams the delta block, bucket-amortized
        dbytes = self.delta_n * self.m * self.bytes_per_val / b
        if method == "scan":
            return self.n * self.m * self.bytes_per_val \
                / (b * max(self.n_devices, 1)) + dbytes
        if method == "scan_vertical":
            return self.n * mq * self.bytes_per_val / b + dbytes
        if method == "rowscan":
            return float(self.n * self.m * self.bytes_per_val) + dbytes
        if method in ("kdtree", "rstar"):
            n_leaves = -(-self.n // self.tile_n)
            prune = 2 * n_leaves * self.m * self.bytes_per_val / b
            side = sel ** (1.0 / mq)
            f = min(1.0, (side + self.leaf_side()) ** mq)
            return prune + f * self.n * self.m * self.bytes_per_val \
                / self.visit_bw_discount + dbytes
        if method == "vafile":
            words = -(-self.m // VA_DIMS_PER_WORD)
            # per-dim slack approximated from the whole-query selectivity
            # (the trace does not carry per-dim estimates)
            cand = min(1.0, (sel ** (1.0 / mq) + 2.0 / VA_CELLS) ** mq)
            blk_frac = 1.0 - (1.0 - cand) ** self.tile_n
            return self.n * words * 4 / b \
                + blk_frac * self.n * self.m * self.bytes_per_val \
                / self.visit_bw_discount + dbytes
        return None

    # -- vectorized per-path costs (batch planning) ------------------------
    # Same formulas as the scalar methods, evaluated for all Q queries of a
    # batch at once. ``bucket`` is the (Q,) per-query amortization size — the
    # realized size of the launch bucket each query lands in under the
    # planner's fixpoint, where the scalar methods take one ``batch`` int.
    def _scan_cost_batch(self, elems: np.ndarray, bucket: np.ndarray,
                         n_devices: int | None) -> np.ndarray:
        d = max(n_devices if n_devices is not None else self.n_devices, 1)
        local = np.asarray(elems, np.float64) / d
        b = np.maximum(np.asarray(bucket, np.float64), 1.0)
        stream = local * self.bytes_per_val * self.sec_per_byte / b
        cost = np.maximum(stream, local * self.sec_per_cmp) \
            + self.dispatch_overhead / b
        if d > 1:
            cost = cost + self.collective_overhead / b
        return cost

    def cost_scan_batch(self, n_queries: int, bucket: np.ndarray,
                        n_devices: int | None = None, spec=None) -> np.ndarray:
        """(Q,) full fused-scan costs (query-independent except amortization)."""
        elems = np.full((n_queries,), float(self.n) * self.m)
        return self._scan_cost_batch(elems, bucket, n_devices) \
            + self._delta_cost_batch(bucket) \
            + self.spec_host_cost(spec, np.full((n_queries,), float(self.n)))

    def cost_scan_vertical_batch(self, mq: np.ndarray, bucket: np.ndarray,
                                 n_devices: int | None = None,
                                 spec=None) -> np.ndarray:
        """(Q,) vertical-scan costs from per-query constrained-dim counts.

        Like the scalar method, defaults to one device: the distributed path
        implements only the full fused scan, so the vertical scan runs on one
        device regardless of the mesh.
        """
        elems = float(self.n) * np.maximum(np.asarray(mq, np.float64), 1.0)
        touched = np.full((np.asarray(mq).shape[0],), float(self.n))
        return self._scan_cost_batch(
            elems, bucket, n_devices if n_devices is not None else 1) \
            + self._delta_cost_batch(bucket) \
            + self.spec_host_cost(spec, touched)

    def cost_tree_batch(self, sels: np.ndarray, mq: np.ndarray,
                        bucket: np.ndarray, spec=None) -> np.ndarray:
        """(Q,) blocked-tree costs from per-query selectivities + dim counts."""
        b = np.maximum(np.asarray(bucket, np.float64), 1.0)
        n_leaves = -(-self.n // self.tile_n)
        prune = 2 * n_leaves * self.m * self.bytes_per_val / b
        mq1 = np.maximum(np.asarray(mq, np.float64), 1.0)
        side = np.asarray(sels, np.float64) ** (1.0 / mq1)
        f = np.minimum(1.0, (side + self.leaf_side()) ** mq1)
        refine = f * self.n * self.m * self.bytes_per_val / self.visit_bw_discount
        return (prune + refine) * self.sec_per_byte \
            + 2.0 * self.dispatch_overhead / b \
            + self.host_sync_overhead / b \
            + self._delta_cost_batch(bucket) \
            + self.spec_host_cost(spec, f * self.n)

    def cost_vafile_batch(self, dim_sels: np.ndarray, dims_mask: np.ndarray,
                          bucket: np.ndarray, spec=None) -> np.ndarray:
        """(Q,) VA-file costs from (Q, m) per-dim selectivities."""
        b = np.maximum(np.asarray(bucket, np.float64), 1.0)
        words = -(-self.m // VA_DIMS_PER_WORD)
        approx = np.maximum(self.n * words * 4 * self.sec_per_byte / b,
                            self.n * self.m * self.sec_per_cmp)
        cand = np.prod(
            np.where(dims_mask,
                     np.minimum(1.0, np.asarray(dim_sels, np.float64)
                                + 2.0 / VA_CELLS),
                     1.0),
            axis=1)
        blk_frac = 1.0 - (1.0 - np.minimum(cand, 1.0)) ** self.tile_n
        refine = blk_frac * self.n * self.m * self.bytes_per_val \
            / self.visit_bw_discount
        return approx + refine * self.sec_per_byte \
            + 2.0 * self.dispatch_overhead / b \
            + self.host_sync_overhead / b \
            + self._delta_cost_batch(bucket) \
            + self.spec_host_cost(spec, blk_frac * self.n)


@dataclasses.dataclass
class Plan:
    method: str
    est_selectivity: float
    costs: dict[str, float]


@dataclasses.dataclass
class BatchPlan:
    """Outcome of one vectorized batch-planning fixpoint (``plan_batch``).

    ``methods[k]`` is query k's access path; ``bucket_sizes`` the realized
    launch buckets the converged amortization priced (they are exactly the
    buckets ``MDRQEngine.query_batch`` executes). ``costs`` is the final
    (paths x Q) matrix over ``path_names`` — inf where a path is not
    applicable to a query.
    """

    methods: list[str]
    est_selectivity: np.ndarray      # (Q,)
    bucket_sizes: dict[str, int]
    n_iterations: int
    converged: bool
    path_names: tuple[str, ...]
    costs: np.ndarray                # (paths, Q) float64


class _PlanStub:
    """Structure-free stand-in for an access path (cost surface only).

    Lets a ``Planner`` be built from path *names* — cost-model studies and
    break-even sweeps price hypothetical configurations (e.g. n=10M) without
    building any structure. Execution methods are deliberately absent: a stub
    can be ranked, never queried.
    """

    plannable = True
    owns_storage = False
    nbytes_index = 0

    def __init__(self, name: str, hist: Histograms):
        self.name = name
        self.hist = hist


class _ScanStub(paths_mod.ScanCost, _PlanStub):
    pass


class _VerticalScanStub(paths_mod.VerticalScanCost, _PlanStub):
    pass


class _TreeStub(paths_mod.TreeCost, _PlanStub):
    pass


class _VAFileStub(paths_mod.VAFileCost, _PlanStub):
    pass


_STUB_KINDS = {
    "scan": _ScanStub,
    "scan_vertical": _VerticalScanStub,
    "kdtree": _TreeStub,
    "rstar": _TreeStub,
    "vafile": _VAFileStub,
}


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Outcome of fitting one machine constant."""

    constant: str
    fitted: float    # raw lstsq coefficient, whatever its sign
    accepted: bool   # written into the model only when positive
    reason: str


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """What ``Planner.calibrate`` did — a failed fit is distinguishable from
    a successful one (the seed silently kept stale constants on rejection)."""

    n_samples: int
    methods: tuple[str, ...]       # distinct access paths that contributed
    fits: tuple[CalibrationFit, ...]
    rms_rel_err: float             # relative residual of the lstsq fit

    @property
    def accepted(self) -> dict[str, bool]:
        return {f.constant: f.accepted for f in self.fits}

    @property
    def ok(self) -> bool:
        return bool(self.fits) and all(f.accepted for f in self.fits)


class Planner:
    """Chooses scan vs index per query — the paper's conclusion, operational.

    Ranks a set of access-path objects (``core.paths.AccessPath``): the
    engine hands over its registry (a shared name -> path dict, so paths
    registered later are planned without touching the planner), while a
    planner built from *names* gets structure-free cost stubs — the form the
    break-even and calibration studies use.
    """

    def __init__(self, hist: Histograms, model: CostModel,
                 available: tuple[str, ...] = ("scan", "scan_vertical", "kdtree", "vafile"),
                 paths: Union[dict, Sequence, None] = None):
        self.hist = hist
        self.model = model
        if paths is not None:
            self._paths = (paths if isinstance(paths, dict)
                           else {p.name: p for p in paths})
        else:
            self._paths = {}
            for name in available:
                kind = _STUB_KINDS.get(name)
                if kind is None:
                    raise ValueError(
                        f"no default cost model for path {name!r}; pass the "
                        f"path object via ``paths=`` instead")
                self._paths[name] = kind(name, hist)

    @property
    def available(self) -> tuple[str, ...]:
        """Names of the plannable paths, in registration order."""
        return tuple(name for name, p in self._paths.items() if p.plannable)

    def _plannable(self) -> list:
        return [(name, p) for name, p in self._paths.items() if p.plannable]

    # Pre-spec paths are priced as if every result were Ids (their
    # historical behavior) rather than erroring out of the planner; the
    # signature probe is cached per function (see ``paths.takes_spec``).
    _takes_spec = staticmethod(paths_mod.takes_spec)

    def explain(self, q: T.RangeQuery, batch_size: int = 1,
                spec: T.ResultSpec = T.IDS) -> Plan:
        """Rank access paths for q; ``batch_size`` amortizes the fixed taxes
        (and fused-scan bytes) over a batch of concurrently executed queries,
        and ``spec`` prices the result payload (reduced shapes read back
        O(k) bytes where Ids reads back a mask). Paths pricing themselves
        inf (not applicable) are omitted."""
        sel = self.hist.selectivity(q)
        costs: dict[str, float] = {}
        for name, p in self._plannable():
            if self._takes_spec(p.cost):
                c = float(p.cost(q, sel, batch_size, self.model, spec=spec))
            else:
                c = float(p.cost(q, sel, batch_size, self.model))
            if np.isfinite(c):
                costs[name] = c
        if not costs:
            raise ValueError("no applicable access path for query")
        method = min(costs, key=costs.get)
        return Plan(method=method, est_selectivity=sel, costs=costs)

    def plan_inputs(self, batch: T.QueryBatch) -> paths_mod.PlanInputs:
        """One vectorized estimation pass over the whole batch's bounds."""
        dims_mask = batch.dims_mask
        dim_sels = self.hist.dim_selectivity_batch(batch.lower, batch.upper)
        sels = self.hist.selectivity_batch(batch.lower, batch.upper,
                                           dim_sels=dim_sels)
        return paths_mod.PlanInputs(
            lower=batch.lower, upper=batch.upper, dims_mask=dims_mask,
            mq=dims_mask.sum(axis=1), dim_sels=dim_sels, sels=sels)

    def plan_batch(self, batch, max_iters: int = 4,
                   spec: T.ResultSpec = T.IDS) -> BatchPlan:
        """Plan a whole batch: vectorized costs + plan -> bucket -> replan.

        Iteration 1 prices every path under whole-batch amortization (the
        optimistic bound — every fused launch the size of the full batch).
        Each later iteration re-prices with the *realized* bucket sizes of
        the previous assignment: for query k, path p amortizes over p's
        current bucket (plus k itself if it would join), so a path that
        looked cheap only because the whole batch paid its fixed taxes loses
        its subsidy once its realized bucket is small. Amortized terms are
        monotone in bucket size, so assignments settle in 2-3 rounds;
        ``max_iters`` bounds the pathological case and ``converged`` reports
        which happened. No step loops over queries in Python.
        """
        if not isinstance(batch, T.QueryBatch):
            batch = T.QueryBatch.from_queries(list(batch))
        pi = self.plan_inputs(batch)
        entries = self._plannable()
        if not entries:
            raise ValueError("no plannable access paths registered")
        names = [name for name, _ in entries]
        q_n = len(batch)
        assign: Optional[np.ndarray] = None
        sizes = np.zeros((len(entries),), np.float64)
        converged = False
        costs = np.empty((len(entries), q_n), np.float64)
        n_iterations = 0
        takes_spec = [self._takes_spec(p.cost_batch) for _, p in entries]
        for n_iterations in range(1, max_iters + 1):
            for j, (_, p) in enumerate(entries):
                bucket = (np.full((q_n,), float(q_n)) if assign is None
                          else sizes[j] + (assign != j))
                c = (p.cost_batch(pi, bucket, self.model, spec=spec)
                     if takes_spec[j]
                     else p.cost_batch(pi, bucket, self.model))
                costs[j] = np.broadcast_to(np.asarray(c, np.float64), (q_n,))
            # NaN costs count as inapplicable, exactly like the scalar
            # ``explain``'s isfinite filter — otherwise argmin would treat
            # NaN as the minimum and silently assign the broken path.
            np.copyto(costs, np.inf, where=np.isnan(costs))
            new_assign = np.argmin(costs, axis=0)
            if assign is not None and np.array_equal(new_assign, assign):
                converged = True
                break
            assign = new_assign
            sizes = np.bincount(assign,
                                minlength=len(entries)).astype(np.float64)
        if np.isinf(costs[assign, np.arange(q_n)]).any():
            # every plannable path priced itself inapplicable for some query
            # — same condition (and error) as the scalar ``explain``
            raise ValueError("no applicable access path for query")
        counts = np.bincount(assign, minlength=len(entries))
        return BatchPlan(
            methods=[names[int(a)] for a in assign],
            est_selectivity=pi.sels,
            bucket_sizes={names[j]: int(c) for j, c in enumerate(counts) if c},
            n_iterations=n_iterations,
            converged=converged,
            path_names=tuple(names),
            costs=costs,
        )

    def explain_batch(self, queries, spec: T.ResultSpec = T.IDS) -> list[Plan]:
        """Per-query plans under whole-batch amortization — literally
        iteration 1 of ``plan_batch``'s fixpoint, reshaped into Plans (kept
        for cost introspection: every Plan carries the per-path cost dict)."""
        queries = list(queries)
        if not queries:
            return []
        bp = self.plan_batch(T.QueryBatch.from_queries(queries), max_iters=1,
                             spec=spec)
        plans = []
        for k in range(len(queries)):
            cd = {name: float(bp.costs[j, k])
                  for j, name in enumerate(bp.path_names)
                  if np.isfinite(bp.costs[j, k])}
            plans.append(Plan(method=bp.methods[k],
                              est_selectivity=float(bp.est_selectivity[k]),
                              costs=cd))
        return plans

    def choose(self, q: T.RangeQuery, batch_size: int = 1) -> str:
        """The access path ``explain`` ranks first for ``q``."""
        return self.explain(q, batch_size=batch_size).method

    def break_even_selectivity(self, m_q: Optional[int] = None,
                               batch_size: int = 1,
                               index_path: str = "tree",
                               n_devices: Optional[int] = None,
                               spec: Optional[T.ResultSpec] = None) -> float:
        """Selectivity where the index (``index_path``) stops beating the scan.

        Bisects the cost model over complete-match queries — reproduces the
        paper's ~1% headline number for paper-like configurations. With
        ``batch_size`` > 1 the break-even reflects batched execution: the
        index's host-sync tax amortizes away (helping indexes at small n),
        but the fused scan's byte amortization pushes the scan toward its
        compute floor (helping scans at large batches) — the net shift is a
        machine-and-batch-size-dependent result the paper's single-query
        analysis (§8) cannot see. ``index_path="vafile"`` bisects the (now
        fully batch-fused) VA-file cost instead of the tree cost.

        ``n_devices`` adds the cross-device axis: the scan's streamed bytes
        (and compute floor) divide over the mesh while the indexes stay
        single-device, so every added device pushes the break-even further
        down — horizontal partitioning (§3.1) extends the paper's "scans win
        below ~1%" conclusion device-linearly, minus the per-launch
        collective tax.

        ``spec`` adds the result-shape axis: under ``Ids()`` the scan reads
        back an n-byte mask per query while the index reads only its visited
        fraction, so the break-even climbs (indexes win a wider band); under
        ``Count()``/``Agg``/``TopK`` the payload is O(1)-O(k) for every path
        and the break-even falls back to the pure kernel-side surface
        (``spec=None``, the default — keeps the recorded tables comparable).
        """
        mq = m_q or self.model.m
        lo_s, hi_s = 1e-8, 1.0

        def tree_wins(sel: float) -> bool:
            q = _synthetic_query(self.model.m, mq, sel)
            if index_path == "vafile":
                idx_cost = self.model.cost_vafile(q, self.hist,
                                                  batch=batch_size, spec=spec)
            else:
                idx_cost = self.model.cost_tree(q, sel, batch=batch_size,
                                                spec=spec)
            return idx_cost < self.model.cost_scan(q, batch=batch_size,
                                                   n_devices=n_devices,
                                                   spec=spec)

        if not tree_wins(lo_s):
            return 0.0
        if tree_wins(hi_s):
            return 1.0
        for _ in range(60):
            mid = np.sqrt(lo_s * hi_s)
            if tree_wins(mid):
                lo_s = mid
            else:
                hi_s = mid
        return float(np.sqrt(lo_s * hi_s))

    def calibrate(self, samples: list[tuple[str, float, float]]
                  ) -> "CalibrationReport":
        """Refit (sec_per_byte, dispatch_overhead) from measured runs.

        Args:
          samples: (method, modeled_bytes, measured_seconds) triples. The
            method names are recorded in the report so callers can see which
            access paths backed the fit.

        Returns:
          A ``CalibrationReport``: each constant is written into the model
          only when its fitted value is positive, and the report says per
          constant whether the fit was accepted — a rejected fit keeps the
          previous constant *visibly* instead of silently looking like a
          successful calibration.
        """
        if not samples:
            return CalibrationReport(n_samples=0, methods=(), fits=(),
                                     rms_rel_err=float("nan"))
        A = np.array([[b, 1.0] for _, b, _ in samples])
        y = np.array([t for _, _, t in samples])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid = (A @ coef - y) / np.maximum(np.abs(y), 1e-30)
        fits = []
        for name, val in (("sec_per_byte", float(coef[0])),
                          ("dispatch_overhead", float(coef[1]))):
            accepted = val > 0.0
            kept = getattr(self.model, name)
            if accepted:
                setattr(self.model, name, val)
            fits.append(CalibrationFit(
                constant=name, fitted=val, accepted=accepted,
                reason="fit accepted" if accepted else
                f"non-positive fit {val:.3e}; keeping {kept:.3e}"))
        return CalibrationReport(
            n_samples=len(samples),
            methods=tuple(sorted({m for m, _, _ in samples})),
            fits=tuple(fits),
            rms_rel_err=float(np.sqrt(np.mean(resid ** 2))),
        )


def _synthetic_query(m: int, mq: int, sel: float) -> T.RangeQuery:
    side = sel ** (1.0 / mq)
    preds = {d: (0.0, side) for d in range(mq)}
    return T.RangeQuery.partial(m, preds)

"""Drift auditing: estimated vs observed selectivity/cost from query traces.

Ports ``repro/obs/audit.py`` unchanged: pure Python over the ``QueryTrace``
records ``MDRQEngine.query_batch(..., trace=True)`` emits.

The planner's break-even machinery is only as good as its inputs — the
independence-assumption histograms and the calibrated machine constants —
and both drift: data distributions shift under ingest, and the constants
were fitted on some other machine (or never fitted at all). The paper's
analytic-model lineage (arxiv 1609.01319) is explicit that a cost model
needs a measured feedback loop; this module is that loop, fed from
*production traces* rather than dedicated benchmarks.

``audit(traces)`` buckets ``QueryTrace`` records into (access path x
estimated-selectivity decile) cells and compares, per cell, the planner's
estimates against what actually happened: mean estimated vs observed
selectivity (where the result shape makes the realized match fraction
derivable — ids/count/mask), and mean estimated cost vs measured seconds.
Cells whose observed/estimated selectivity ratio leaves the tolerance band
are flagged ``drifted`` — a skewed histogram shows up as a run of drifted
cells on one path before it ever mis-routes enough queries to notice in a
benchmark.

``calibration_samples(traces, model)`` turns the same traces into the
``(method, modeled_bytes, measured_seconds)`` triples ``Planner.calibrate``
fits machine constants from — so miscalibration detected by the audit is
*repaired* through the existing ``CalibrationReport`` plumbing, closing the
loop: trace -> audit -> calibrate -> better plans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

from repro_torch.obs.tracing import BatchTrace, QueryTrace


def _flatten(traces) -> list[QueryTrace]:
    if isinstance(traces, (BatchTrace, QueryTrace)):
        traces = [traces]
    out: list[QueryTrace] = []
    for t in traces:
        if isinstance(t, BatchTrace):
            out.extend(t.queries)
        elif isinstance(t, QueryTrace):
            out.append(t)
        else:
            raise TypeError(f"expected QueryTrace/BatchTrace, got {type(t)}")
    return out


def _decile(sel: float) -> int:
    """Estimated-selectivity decile 0..9 (decile 0 = [0, 0.1), ... )."""
    return min(9, max(0, int(sel * 10.0)))


@dataclasses.dataclass
class AuditCell:
    """One (path x estimated-selectivity decile) aggregation cell."""

    method: str
    decile: int                    # of the *estimated* selectivity
    n_queries: int
    n_observed: int                # queries with a derivable observed sel
    mean_est_sel: float
    mean_obs_sel: float            # NaN when nothing was derivable
    sel_ratio: float               # observed / estimated (NaN if unobserved)
    mean_est_cost: float           # planner seconds (NaN for explicit runs)
    mean_seconds: float            # measured per-query seconds
    cost_ratio: float              # measured / estimated (NaN if unplanned)
    drifted: bool

    def __str__(self) -> str:
        flag = " DRIFT" if self.drifted else ""
        return (f"{self.method:>14s} d{self.decile} n={self.n_queries:<5d} "
                f"sel est={self.mean_est_sel:.3e} obs={self.mean_obs_sel:.3e} "
                f"(x{self.sel_ratio:.2f})  cost est={self.mean_est_cost:.3e}s "
                f"meas={self.mean_seconds:.3e}s (x{self.cost_ratio:.2f})"
                f"{flag}")


@dataclasses.dataclass
class DriftReport:
    """Outcome of one audit pass over a trace set."""

    cells: list[AuditCell]
    n_traces: int
    n_unobserved: int              # traces without a derivable observed sel
    sel_tolerance: float
    cost_tolerance: Optional[float]

    @property
    def drifted(self) -> list[AuditCell]:
        return [c for c in self.cells if c.drifted]

    @property
    def ok(self) -> bool:
        return not self.drifted

    def summary(self) -> str:
        head = (f"drift audit: {self.n_traces} traces, {len(self.cells)} "
                f"(path x sel-decile) cells, {len(self.drifted)} drifted "
                f"(sel tolerance x{self.sel_tolerance:g})")
        return "\n".join([head] + [f"  {c}" for c in self.cells])


def audit(traces: Iterable, sel_tolerance: float = 4.0,
          cost_tolerance: Optional[float] = None,
          min_queries: int = 1) -> DriftReport:
    """Aggregate traces into (path x sel-decile) cells and flag drift.

    A cell drifts when its mean observed selectivity is more than
    ``sel_tolerance``x off the mean estimate (either direction), or — when
    ``cost_tolerance`` is given — when measured seconds leave the analogous
    band around the planner's cost estimate (off by default: measured wall
    time against the cost model's placeholder constants is a calibration
    question, which is what ``calibration_samples`` + ``Planner.calibrate``
    are for). Cells
    with fewer than ``min_queries`` observed queries are reported but never
    flagged (one noisy query is not drift).
    """
    flat = _flatten(traces)
    groups: dict[tuple[str, int], list[QueryTrace]] = {}
    n_unobserved = 0
    for t in flat:
        groups.setdefault((t.method, _decile(t.est_selectivity)), []).append(t)
        if t.obs_selectivity is None:
            n_unobserved += 1

    cells = []
    for (method, dec), ts in sorted(groups.items()):
        obs = [t for t in ts if t.obs_selectivity is not None]
        est_sel = sum(t.est_selectivity for t in ts) / len(ts)
        obs_sel = (sum(t.obs_selectivity for t in obs) / len(obs)
                   if obs else math.nan)
        # ratio on floored estimates: est_sel is already clamped >= 1/n by
        # the histograms, but guard anyway (a zero estimate must read as
        # "infinitely drifted", not a ZeroDivisionError)
        sel_ratio = (obs_sel / est_sel if est_sel > 0 else math.inf) \
            if obs else math.nan
        planned = [t for t in ts if not math.isnan(t.est_cost)]
        est_cost = (sum(t.est_cost for t in planned) / len(planned)
                    if planned else math.nan)
        seconds = sum(t.seconds for t in ts) / len(ts)
        cost_ratio = (seconds / est_cost if est_cost and est_cost > 0
                      else math.nan) if planned else math.nan
        drifted = False
        if len(obs) >= min_queries and not math.isnan(sel_ratio):
            drifted = not (1.0 / sel_tolerance <= sel_ratio <= sel_tolerance)
        if (not drifted and cost_tolerance is not None
                and len(planned) >= min_queries
                and not math.isnan(cost_ratio)):
            drifted = not (1.0 / cost_tolerance <= cost_ratio
                           <= cost_tolerance)
        cells.append(AuditCell(
            method=method, decile=dec, n_queries=len(ts), n_observed=len(obs),
            mean_est_sel=est_sel, mean_obs_sel=obs_sel, sel_ratio=sel_ratio,
            mean_est_cost=est_cost, mean_seconds=seconds,
            cost_ratio=cost_ratio, drifted=drifted))
    return DriftReport(cells=cells, n_traces=len(flat),
                       n_unobserved=n_unobserved,
                       sel_tolerance=sel_tolerance,
                       cost_tolerance=cost_tolerance)


def calibration_samples(traces: Iterable, model
                        ) -> list[tuple[str, float, float]]:
    """Traces -> ``Planner.calibrate`` samples, closing the feedback loop.

    Each trace contributes ``(method, modeled_bytes, measured_seconds)``:
    the bytes the cost model says that query's execution moved (per query,
    under its realized bucket amortization — ``CostModel.modeled_bytes``)
    against the seconds the trace actually measured for it. Feeding the
    result to ``Planner.calibrate`` refits ``sec_per_byte`` /
    ``dispatch_overhead`` from production traffic, and the returned
    ``CalibrationReport`` says which constants the fit repaired.

    Selectivity-dependent paths use the *observed* selectivity where the
    trace has one (that is the whole point: the estimate may be the thing
    that drifted) and fall back to the estimate otherwise.
    """
    samples = []
    for t in _flatten(traces):
        sel = t.obs_selectivity if t.obs_selectivity is not None \
            else t.est_selectivity
        nbytes = model.modeled_bytes(t.method, sel=sel, mq=t.mq,
                                     bucket=t.bucket_size)
        if nbytes is not None:
            samples.append((t.method, float(nbytes), float(t.seconds)))
    return samples

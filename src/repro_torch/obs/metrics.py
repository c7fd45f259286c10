"""Metrics registry: named counters / gauges / fixed-bucket histograms.

The measurement substrate of the observability layer (DESIGN.md §10). Three
metric kinds, all plain host-side Python (never inside jit):

  * ``Counter``   — monotone event counts. The kernel launch / host-sync
    accounting in ``kernels.ops`` is a *client* of this registry (family
    ``mdrq_launches_total{op=...}``), not a separate global: every budget a
    test asserts and every span's launch attribution read the same numbers.
  * ``Gauge``     — last-write-wins instantaneous values.
  * ``Histogram`` — fixed log-spaced buckets with cumulative counts, the
    Prometheus histogram shape. Percentiles (p50/p95/p99 of serving latency)
    interpolate within the containing bucket, so their error is bounded by
    one bucket ratio (``LATENCY_BUCKET_RATIO``) — cheap enough to record on
    every flush, honest enough for the ``ServerStats`` report.

Metrics are keyed by (name, sorted label items): ``registry().counter("x",
op="scan")`` and ``op="tree"`` are two series of one family, exactly the
Prometheus data model, so the text exporter is a straight serialization.

Exporters: ``to_jsonl()`` (one JSON object per line — machine-readable, the
``BENCH_*.json`` trajectory and any log shipper parse it back) and
``to_prometheus()`` (the text exposition format).

This module imports nothing from the rest of ``repro_torch`` — it is the leaf the
kernel layer, the engine, and the server all hang their instruments on.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable, Optional

_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotone event counter."""

    name: str
    labels: dict[str, str]
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    labels: dict[str, str]
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


# Default latency buckets: log-spaced from 1us to ~2 minutes. The ratio is
# the percentile error bound — within-bucket interpolation can never be off
# by more than one bucket, so p50/p95/p99 are exact to ~1.35x.
LATENCY_BUCKET_RATIO = 1.35
LATENCY_BUCKETS: tuple[float, ...] = tuple(
    1e-6 * LATENCY_BUCKET_RATIO ** k for k in range(62))


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds[i]`` is the inclusive upper edge of bucket i; observations above
    the last edge land in the +Inf overflow bucket. ``sum``/``count``/``min``
    /``max`` ride along so means and exact extremes survive the bucketing.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "_min", "_max")

    def __init__(self, name: str, labels: dict[str, str],
                 bounds: Optional[Iterable[float]] = None):
        self.name = name
        self.labels = labels
        self.bounds = tuple(bounds) if bounds is not None else LATENCY_BUCKETS
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bucket bounds must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: +Inf overflow
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        # binary search: bisect over the sorted edges
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if x <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (0 < p <= 100), interpolated within the
        containing bucket and clamped to the observed [min, max]."""
        if not 0.0 < p <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got {p}")
        if self.count == 0:
            return float("nan")
        target = p / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo_edge = self.bounds[i - 1] if i > 0 else 0.0
                hi_edge = self.bounds[i] if i < len(self.bounds) else self._max
                frac = (target - cum) / c
                est = lo_edge + frac * (hi_edge - lo_edge)
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    def percentiles(self, ps: Iterable[float] = (50, 95, 99)
                    ) -> dict[str, float]:
        """{"p50": ..., "p95": ..., "p99": ...} — the ServerStats report."""
        return {f"p{g:g}": self.percentile(g) for g in ps}

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf


class MetricsRegistry:
    """Name+labels -> metric store with JSONL / Prometheus exporters.

    ``counter``/``gauge``/``histogram`` get-or-create: hot paths hold the
    returned object (one dict lookup per lookup, zero per increment).
    ``reset()`` zeroes values but keeps the objects, so cached references in
    ``kernels.ops`` and long-lived spans stay live across test resets.
    """

    def __init__(self):
        self._metrics: dict[tuple[str, _LabelKey], object] = {}
        self._help: dict[str, str] = {}

    def _get(self, cls, name: str, labels: dict[str, str], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name=name, labels=dict(labels), **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r}{labels} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        if help:
            self._help.setdefault(name, help)
        return self._get(Counter, name, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        if help:
            self._help.setdefault(name, help)
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        if help:
            self._help.setdefault(name, help)
        return self._get(Histogram, name, labels, bounds=bounds)

    # -- introspection -----------------------------------------------------
    def series(self, name: str) -> list:
        """All metrics of one family (every label combination), in
        registration order."""
        return [m for (n, _), m in self._metrics.items() if n == name]

    def family_total(self, name: str) -> float:
        """Summed value of a counter/gauge family across all label sets."""
        return float(sum(m.value for m in self.series(name)))

    def counter_values(self, name: str, label: str) -> dict[str, float]:
        """{label value -> count} for one counter family keyed by ``label``
        (e.g. per-op launch counts) — the span layer's attribution source.

        Zero-valued series are omitted (matching ``kernels.ops.counters``):
        ``reset()`` keeps counter objects alive so cached references stay
        live, and a series another code path touched before the reset should
        not reappear here as a spurious ``0.0`` entry.
        """
        return {m.labels.get(label, ""): m.value
                for m in self.series(name) if m.value}

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    # -- exporters ---------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """One JSON-able dict per metric (the JSONL exporter's rows)."""
        rows = []
        for (name, _), m in self._metrics.items():
            row: dict = {"name": name, "labels": dict(m.labels)}
            if isinstance(m, Histogram):
                cum = 0
                buckets = []
                for edge, c in zip(self.bounds_of(m), m.counts):
                    cum += c
                    if c:  # sparse: only non-empty buckets ship
                        buckets.append([edge, cum])
                row.update(type="histogram", count=m.count, sum=m.sum,
                           buckets=buckets, **m.percentiles())
            else:
                row.update(
                    type="counter" if isinstance(m, Counter) else "gauge",
                    value=m.value)
            rows.append(row)
        return rows

    @staticmethod
    def bounds_of(h: Histogram) -> list[float]:
        return list(h.bounds) + [math.inf]

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(r) for r in self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one family header, then every
        labeled series; histograms as _bucket/_sum/_count)."""
        out: list[str] = []
        seen: set[str] = set()
        for (name, _), m in self._metrics.items():
            if name not in seen:
                seen.add(name)
                kind = ("histogram" if isinstance(m, Histogram)
                        else "counter" if isinstance(m, Counter) else "gauge")
                if name in self._help:
                    out.append(f"# HELP {name} {self._help[name]}")
                out.append(f"# TYPE {name} {kind}")
            for line in _prom_lines(name, m):
                out.append(line)
        return "\n".join(out) + "\n"


def _prom_labels(labels: dict[str, str], extra: str = "") -> str:
    items = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        items.append(extra)
    return "{" + ",".join(items) + "}" if items else ""


def _prom_num(x: float) -> str:
    if x == math.inf:
        return "+Inf"
    return repr(int(x)) if float(x).is_integer() and abs(x) < 1e15 else repr(x)


def _prom_lines(name: str, m) -> list[str]:
    if isinstance(m, Histogram):
        lines = []
        cum = 0
        for edge, c in zip(MetricsRegistry.bounds_of(m), m.counts):
            cum += c
            if c or edge == math.inf:  # sparse buckets; always emit +Inf
                le = _prom_labels(m.labels, f'le="{_prom_num(edge)}"')
                lines.append(f"{name}_bucket{le} {cum}")
        lab = _prom_labels(m.labels)
        lines.append(f"{name}_sum{lab} {_prom_num(m.sum)}")
        lines.append(f"{name}_count{lab} {m.count}")
        return lines
    return [f"{name}{_prom_labels(m.labels)} {_prom_num(m.value)}"]


# The process-wide default registry. Everything in-tree records here; the
# port's tests reset it per test through an autouse fixture.
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY

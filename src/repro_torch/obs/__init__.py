"""repro_torch.obs — metrics registry, device-sync-aware spans, query log.

  * ``obs.metrics``  — counters / gauges / fixed-bucket histograms in one
    registry with JSONL + Prometheus exporters. The op layer's
    launch/host-sync counters are one series family of this registry.
  * ``obs.tracing``  — the span API with a close that waits for the device,
    plus the ``QueryTrace``/``BatchTrace`` records
    ``MDRQEngine.query_batch(..., trace=True)`` emits.
  * ``obs.querylog`` — the bounded reservoir-sampled query log
    ``MDRQServer`` keeps.
  * ``obs.audit``    — estimated-vs-observed drift report per (path x
    selectivity-decile) cell, and the bridge from traces to
    ``Planner.calibrate``.

This package never imports engine or kernel code.
"""
from repro_torch.obs.audit import (AuditCell, DriftReport, audit,
                                   calibration_samples)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, registry)
from repro_torch.obs.querylog import QueryLog, QueryLogEntry
from repro_torch.obs.tracing import (NULL_SPAN, BatchTrace, QueryTrace, Span,
                                     Tracer, enabled, span)

__all__ = [
    "AuditCell", "DriftReport", "audit", "calibration_samples",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "QueryLog", "QueryLogEntry",
    "NULL_SPAN", "BatchTrace", "QueryTrace", "Span", "Tracer", "enabled",
    "span",
]

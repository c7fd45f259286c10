"""Query-path tracing: lightweight spans + per-query ``QueryTrace`` records.

The span API is deliberately tiny:

    with obs.span("plan"):
        ...
    with obs.span("kernel", path="scan") as sp:
        out = launch(...)
        sp.block_on(out)          # device-sync-aware close

Spans are host-side objects. PyTorch returns from a CUDA launch before the
device finishes, so a span wrapping a launch would stop its clock at
*dispatch*: ``Span.block_on`` registers values and the close waits for the
device (``torch.cuda.synchronize``) when any of them is a CUDA tensor, so a
kernel span measures device completion, not how fast Python returned.

Cost when disabled is one thread-local load and an ``is None`` check:
``span(...)`` returns the shared ``NULL_SPAN`` singleton, so ``trace=False``
execution allocates nothing.

Launch/host-sync attribution: every span snapshots the metrics registry's
``mdrq_launches_total`` family at open and close (the counters
``kernels.ops`` bumps), so a span knows how many op launches and host syncs
happened under it.

``QueryTrace``/``BatchTrace`` are the records ``MDRQEngine.query_batch(...,
trace=True)`` produces: per query, the planner's chosen path, realized bucket,
estimated selectivity and cost, the realized result size (and the observed
selectivity where the spec makes it derivable), plus the bucket's measured
seconds / launches / host syncs.
"""
from __future__ import annotations

import dataclasses
import threading as _threading
import time
from typing import Any, Optional

import torch

from repro_torch.obs import metrics as _metrics

# The one counter family the op layer bumps (see kernels/ops.py); the
# device->host sync pseudo-op lives in the same family under this op label.
LAUNCH_FAMILY = "mdrq_launches_total"
HOST_SYNC_OP = "host_sync"


def _launch_snapshot() -> tuple[float, float]:
    """(op launches, host syncs) since process start, from the registry."""
    launches = 0.0
    syncs = 0.0
    for m in _metrics.registry().series(LAUNCH_FAMILY):
        if m.labels.get("op") == HOST_SYNC_OP:
            syncs += m.value
        else:
            launches += m.value
    return launches, syncs


def _cuda_devices(x, out: set) -> set:
    """Devices of the CUDA tensors inside ``x`` (tensors, tuples, lists)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for e in x:
            _cuda_devices(e, out)
    return out


class Span:
    """One timed region. Context manager; closes device-sync-aware."""

    __slots__ = ("name", "attrs", "seconds", "children", "launches",
                 "host_syncs", "_tracer", "_t0", "_c0", "_pending")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.seconds = 0.0
        self.children: list[Span] = []
        self.launches = 0
        self.host_syncs = 0
        self._tracer = tracer
        self._t0 = 0.0
        self._c0 = (0.0, 0.0)
        self._pending: list = []

    def set(self, **attrs) -> "Span":
        """Attach attributes after open (result counts, bucket sizes, ...)."""
        self.attrs.update(attrs)
        return self

    def block_on(self, x) -> None:
        """Register a value the span close must wait for, so the span
        measures device completion rather than asynchronous dispatch."""
        self._pending.append(x)

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._c0 = _launch_snapshot()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._pending:
            for dev in _cuda_devices(self._pending, set()):
                torch.cuda.synchronize(dev)
            self._pending = []
        self.seconds = time.perf_counter() - self._t0
        c1 = _launch_snapshot()
        self.launches = int(c1[0] - self._c0[0])
        self.host_syncs = int(c1[1] - self._c0[1])
        self._tracer._pop(self)

    def find(self, name: str) -> list["Span"]:
        """All descendant spans (and self) with the given name, pre-order."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.seconds * 1e6:.0f}us, "
                f"launches={self.launches}, host_syncs={self.host_syncs}, "
                f"attrs={self.attrs})")


class _NullSpan:
    """The disabled-tracing singleton: every method is a no-op. ``span()``
    returns this exact object when no tracer is active, so the hot path
    allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **attrs) -> "_NullSpan":
        return self

    def block_on(self, x) -> None:
        return None


NULL_SPAN = _NullSpan()

# The active tracer, *per thread*: a Tracer installed on one thread sees
# exactly that thread's spans; other threads' span() calls return NULL_SPAN.
_TLS = _threading.local()


def enabled() -> bool:
    return getattr(_TLS, "tracer", None) is not None


def span(name: str, **attrs):
    """Open a span under the calling thread's active tracer, or the no-op
    singleton when tracing is disabled on this thread."""
    t = getattr(_TLS, "tracer", None)
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs)


def current() -> Optional["Tracer"]:
    """The calling thread's active tracer, or None."""
    return getattr(_TLS, "tracer", None)


class Tracer:
    """Collects a span tree. ``with Tracer() as t:`` installs it as the
    active tracer (nesting restores the previous one on exit)."""

    def __init__(self):
        self.spans: list[Span] = []   # root spans, in open order
        self._stack: list[Span] = []
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> "Tracer":
        self._prev = getattr(_TLS, "tracer", None)
        _TLS.tracer = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _TLS.tracer = self._prev
        self._prev = None

    def _push(self, s: Span) -> None:
        (self._stack[-1].children if self._stack else self.spans).append(s)
        self._stack.append(s)

    def _pop(self, s: Span) -> None:
        if self._stack and self._stack[-1] is s:
            self._stack.pop()

    def find(self, name: str) -> list[Span]:
        out = []
        for s in self.spans:
            out.extend(s.find(name))
        return out


# =============================================================================
# Query-trace records (what the engine emits under trace=True)
# =============================================================================

@dataclasses.dataclass(slots=True)
class QueryTrace:
    """One query's observed execution, planner estimates included.

    ``seconds``/``launches``/``host_syncs`` are the query's *amortized share*
    of its fused launch bucket (bucket totals divided by ``bucket_size``) —
    the same amortization the cost model prices. ``obs_selectivity`` is the
    realized match fraction where the result shape makes it derivable (ids /
    count / mask), else None.
    """

    index: int                     # position in the submitted batch
    method: str                    # access path executed
    bucket_size: int               # realized fused-launch bucket
    est_selectivity: float         # planner estimate (histograms)
    est_cost: float                # planner cost estimate, model units (NaN
    #                                when the method was explicit, not planned)
    spec_kind: str                 # result shape served
    mq: int                        # constrained dims
    result_size: int               # realized result magnitude (spec-typed)
    obs_selectivity: Optional[float]
    seconds: float                 # measured wall share of the bucket
    launches: float                # op launches / bucket_size
    host_syncs: float              # host syncs / bucket_size


@dataclasses.dataclass
class BatchTrace:
    """One ``query_batch(trace=True)`` execution: per-query records plus the
    batch-level plan/execute breakdown and the raw span tree."""

    n: int                         # dataset objects (obs selectivity divisor)
    n_queries: int
    spec_kind: str
    plan_seconds: float
    seconds: float
    queries: list[QueryTrace]
    spans: list[Span]

    def by_method(self) -> dict[str, list[QueryTrace]]:
        out: dict[str, list[QueryTrace]] = {}
        for t in self.queries:
            out.setdefault(t.method, []).append(t)
        return out

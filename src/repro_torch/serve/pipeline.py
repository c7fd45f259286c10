"""Warmed, double-buffered MDRQ serving pipeline.

Ports ``repro/serve/pipeline.py``. ``MDRQServer`` is synchronous: every
flush pays plan + launch + host sync + host finalize back to back on one
thread, so the card idles while the host runs the finalizers, and the
admission loop idles while the card scans. ``PipelinedMDRQServer`` splits
the flush along the seam the engine exposes (``MDRQEngine.launch_batch`` ->
``PendingBatch``):

  * **device stage** (admission thread): plan the window and issue every
    bucket's fused launch — CUDA launches return before the card finishes,
    so this returns while the card still computes. The in-flight
    ``PendingBatch`` crosses to the finalizer through a *bounded* backlog
    queue (the double buffer: window k+1 launches while window k executes
    and finalizes).
  * **finalize stage** (its own thread): the one counted ``ops.device_get``
    per bucket + the spec's host finalizers + ticket resolution. The
    launches and syncs of a window are those of the synchronous path — the
    stages are the same work, relocated. A two-phase bucket (kd-tree,
    R*-tree, VA-file) still reads its visit list back between its two
    launches, on the admission thread, and a bucket whose path lacks the
    split protocol runs whole there (``MDRQEngine.launch_batch``); the
    budget per window is unchanged by either.

**Streams.** On a CUDA engine the device stage launches on a stream of its
own and the finalizer copies on another: each window records an event after
its launches, and the copy stream waits for that event alone, so window k's
copy runs beside window k+1's kernels instead of queueing behind them on
one stream. The launch stream first waits for the caller's stream, so work
the caller queued before a flush (an ingest's copies) is ordered before it.
A payload is allocated on the launch stream and read on the copy stream;
its copy completes (``device_get`` returns host arrays) before the payload
can be freed, so the allocator cannot hand its memory to a later launch
while the copy is in flight. On the CPU there are no streams.

**Warmup**: at construction (and after every ``compact``) the server runs
each pow2 query bucket up to ``max_batch``, for every warm path, under the
server's spec, once — on the launch stream, whose allocator pool then holds
those shapes. The port compiles nothing per shape; its cold costs are the
load of the CUDA extensions and the caching allocator's first allocations.
``ops`` notes every counted call's key (op, argument shapes, statics) in its
warm set, and ``WarmupReport.keys`` is exactly what a pass added: steady
traffic of the advertised shapes adds no key (``ops.trace_log()`` stays
empty). Visit lists of the two-phase paths have data-dependent pow2 lengths:
the warm batch covers their widest bucket only, as in the reference.

**Admission control**: ``submit`` sheds with a typed ``Overloaded`` ticket
once ``(backlog depth + 1) x EWMA window seconds`` exceeds
``latency_budget_s`` — the server refuses work it cannot serve in time
instead of growing an unbounded queue. Sheds are visible in
``ServerStats.shed_counts`` and ``mdrq_server_shed_total``.

Threading contract: device values cross threads only inside a
``PendingBatch`` riding the backlog queue; the finalize syncs run only on
the finalizer thread; stage membership is declared with the
``@device_stage`` / ``@finalizer_stage`` decorators. The threads share no
lock of their own — each ``ServerStats`` field has exactly one writer
thread (admission: ``shed_counts`` / ``flush_reasons``; finalizer:
everything else), the queue orders the windows, and the op counters take
their own lock (``ops``).

The synchronous ``MDRQServer`` remains the default and the deterministic
test surface; ``serve_pipelined(engine)`` is the opt-in factory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import numerics, obs
from repro_torch.core import types as T
from repro_torch.core.engine import MDRQEngine, PendingBatch
from repro_torch.core.types import RangeQuery
from repro_torch.kernels import ops
from repro_torch.obs import tracing as obs_tracing
from repro_torch.serve.mdrq_server import MDRQServer, Ticket


def device_stage(fn):
    """Mark a function as device-stage: runs on the admission thread, may
    launch device work, must not sync the window's payload and must not
    park device values on ``self`` — in-flight payloads cross to the
    finalizer only through the backlog queue."""
    fn.__mdrq_stage__ = "device"
    return fn


def finalizer_stage(fn):
    """Mark a function as finalize-stage: runs on the finalizer thread and
    owns the window's counted ``ops.device_get`` syncs."""
    fn.__mdrq_stage__ = "finalize"
    return fn


class Overloaded(RuntimeError):
    """The server shed this query at admission: the backlog's estimated
    drain time exceeded the latency budget. Retry later or elsewhere."""


@dataclasses.dataclass
class PipelineTicket(Ticket):
    """Event-backed ticket for pipelined serving.

    ``result()`` raises ``Overloaded`` for shed queries, re-raises the
    window's failure if its finalize raised, and otherwise blocks until the
    finalizer thread resolves the window this ticket flushed with.
    """

    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    _inflight: bool = False
    _shed: bool = False
    _error: Optional[BaseException] = None

    @property
    def shed(self) -> bool:
        return self._shed

    def result(self, timeout: Optional[float] = None):
        if self._shed:
            raise Overloaded(
                "query shed at admission: backlog exceeds the latency "
                "budget (see ServerStats.shed_counts)")
        if not self._done and not self._inflight:
            self._server.flush()
        if not self._event.wait(timeout):
            raise TimeoutError(f"pipelined result not ready in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Window:
    """One flushed window in flight between the stages."""

    pending: list    # [(RangeQuery, PipelineTicket, t_submit)], flush order
    reason: str
    batch: PendingBatch
    t_flush: float         # device-stage start (queue latency anchor)
    launch_seconds: float  # device-stage wall (plan + launch)
    ready: Optional[torch.cuda.Event] = None  # after the window's launches


@dataclasses.dataclass(frozen=True)
class WarmupReport:
    """What one warmup pass advertised and ran.

    ``keys`` is exactly the set of ``ops`` warm keys this pass added — the
    advertised set tests assert against; it is empty when every key was
    already warm."""

    paths: tuple[str, ...]
    bucket_sizes: tuple[int, ...]
    dim_counts: tuple[int, ...]
    spec_kind: str
    n_runs: int
    seconds: float
    keys: tuple


def _warm_batch(n_q: int, n_dims: int, m: int) -> T.QueryBatch:
    """A (n_q, m) warmup batch constraining the first ``n_dims`` dims.

    Constrained dims carry the widest *finite* float32 bounds (finite so
    they count as constrained; widest so tree and VA-file warmups traverse
    their largest visit bucket); the rest are +-inf match-alls. The launch
    shapes — what a warm key records — match real traffic exactly. Every
    row matches, so warming an Ids or Mask server materializes every id of
    every warm query once.
    """
    lo = np.full((n_q, m), -np.inf, np.float32)
    up = np.full((n_q, m), np.inf, np.float32)
    lo[:, :n_dims] = numerics.finite_min(np.float32)
    up[:, :n_dims] = numerics.finite_max(np.float32)
    return T.QueryBatch(lo, up)


class PipelinedMDRQServer(MDRQServer):
    """Double-buffered MDRQ server: overlapped device and finalize stages,
    warmup, a bounded backlog, and admission-control shedding.

    Drop-in for ``MDRQServer`` (same submit/poll/flush/ingest surface) with
    extras: ``warmup()``, ``drain()``, ``close()`` (or use it as a context
    manager), ``latency_budget_s``. Ticket ``result()`` calls block on the
    finalizer thread instead of running the batch inline.
    """

    ticket_cls = PipelineTicket

    def __init__(
        self,
        engine: MDRQEngine,
        max_batch: int = 128,
        max_wait_s: float = 2e-3,
        method: str = "auto",
        spec=None,
        mode: Optional[str] = None,
        query_log_capacity: int = 512,
        *,
        backlog: int = 4,
        latency_budget_s: float = 0.25,
        warmup: bool = True,
    ):
        super().__init__(engine, max_batch=max_batch, max_wait_s=max_wait_s,
                         method=method, spec=spec, mode=mode,
                         query_log_capacity=query_log_capacity)
        if backlog < 1:
            raise ValueError(f"backlog must be >= 1, got {backlog}")
        self.latency_budget_s = latency_budget_s
        # The double buffer: in-flight windows between the stages. ``put``
        # blocks when full — backpressure on the admission thread, so device
        # work can never run unboundedly ahead of host finalization.
        self._backlog: "queue.Queue[Optional[_Window]]" = \
            queue.Queue(maxsize=backlog)
        self._ewma_batch_s = 0.0   # finalizer-thread-only writer
        self._wall_t0: Optional[float] = None
        self._closed = False
        self._warmup_enabled = bool(warmup)
        self.last_warmup: Optional[WarmupReport] = None
        # (launch stream, copy stream) on a CUDA engine, else None
        self._streams = self._stage_streams(engine.device)
        self._finalizer = threading.Thread(
            target=self._finalize_loop, name="mdrq-finalizer", daemon=True)
        self._finalizer.start()
        if warmup:
            self.warmup()

    @staticmethod
    def _stage_streams(device: torch.device):
        if device.type != "cuda":
            return None
        return torch.cuda.Stream(device), torch.cuda.Stream(device)

    @property
    def stream_scheme(self) -> str:
        """How the stages use the card: "launch+copy streams" or "none"."""
        return "launch+copy streams" if self._streams else "none"

    def _launch_stream(self):
        """Context for device-stage work: the launch stream, ordered after
        whatever the caller queued on its own stream."""
        if self._streams is None:
            return contextlib.nullcontext()
        launch = self._streams[0]
        launch.wait_stream(torch.cuda.current_stream(launch.device))
        return torch.cuda.stream(launch)

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "PipelinedMDRQServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush the pending window and block until every in-flight window
        has finalized (the backlog is empty and all tickets resolved).
        Raises ``TimeoutError`` if that takes longer than ``timeout``."""
        self.flush()
        done = self._backlog.all_tasks_done
        with done:
            if not done.wait_for(lambda: not self._backlog.unfinished_tasks,
                                 timeout):
                raise TimeoutError(f"backlog not drained in {timeout}s")

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop the finalizer thread. Idempotent. Raises
        ``TimeoutError`` if either takes longer than ``timeout``."""
        if self._closed:
            return
        self.drain(timeout)
        self._closed = True
        self._backlog.put(None)   # stop sentinel
        self._finalizer.join(timeout)
        if self._finalizer.is_alive():
            raise TimeoutError(f"finalizer thread still running after "
                               f"{timeout}s")

    def reset_stats(self) -> None:
        """Fresh stats AND a fresh wall-clock anchor: ``wall_seconds`` must
        measure the next pass only, not everything since construction. Call
        only between passes (after ``drain()``), never with windows in
        flight — the finalizer thread writes stats concurrently otherwise."""
        super().reset_stats()
        self._wall_t0 = None

    # -- warmup --------------------------------------------------------------
    def warmup(self) -> WarmupReport:
        """Run the hot path's launch shapes once -> ``WarmupReport``.

        Sweeps every pow2 bucket size up to ``max_batch`` for every warm
        path (all plannable paths under ``method="auto"``, else the explicit
        path), under the server's spec and the engine's *current* delta
        snapshot. The vertical scan additionally sweeps pow2 constrained-dim
        counts (its launch shapes vary with ``next_pow2(max mq)``).
        Steady-state traffic whose shapes were advertised here finds every
        op key warm: ``ops.trace_log()`` stays empty. Re-run automatically
        after ``compact`` (new data shapes).
        """
        t0 = time.perf_counter()
        engine = self.engine
        paths = engine.paths
        m = engine.dataset.m
        dview = engine.delta.snapshot()
        delta_arg = None if dview.is_empty else dview
        if self.method == "auto":
            names = tuple(n for n, p in paths.items()
                          if getattr(p, "plannable", True))
        else:
            names = (self.method,)
        sizes, b = [], 1
        top = T.next_pow2(self.max_batch)
        while b <= top:
            sizes.append(b)
            b *= 2
        dim_counts = tuple(sorted({min(T.next_pow2(k), m)
                                   for k in range(1, m + 1)}))
        before = set(ops.warm_keys())
        n_runs = 0
        with obs_tracing.span("warmup", paths=len(names)), \
                self._launch_stream():
            for name in names:
                path = paths[name]
                dcs = dim_counts if name == "scan_vertical" else (m,)
                for d in dcs:
                    for bsz in sizes:
                        engine._path_query_batch(
                            path, _warm_batch(bsz, d, m), self.spec,
                            delta=delta_arg)
                        n_runs += 1
        keys = tuple(k for k in ops.warm_keys() if k not in before)
        self.last_warmup = WarmupReport(
            paths=names, bucket_sizes=tuple(sizes), dim_counts=dim_counts,
            spec_kind=self.spec.kind, n_runs=n_runs,
            seconds=time.perf_counter() - t0, keys=keys)
        return self.last_warmup

    def compact(self):
        """Compact the engine, then re-warm: the swapped-in version's device
        tensors have new shapes."""
        out = super().compact()
        if self._warmup_enabled:
            self.warmup()
        return out

    # -- admission control ---------------------------------------------------
    def _should_shed(self) -> bool:
        # (windows not yet finalized + the one this query would join) x the
        # EWMA window cost ~= time until this query's result; shed when that
        # exceeds the budget. EWMA 0.0 until the first window completes —
        # cold start never sheds.
        if self._ewma_batch_s <= 0.0:
            return False
        est = (self._backlog.unfinished_tasks + 1) * self._ewma_batch_s
        return est > self.latency_budget_s

    @device_stage
    def submit(self, q: RangeQuery) -> Ticket:
        """Admission: shed with an ``Overloaded`` ticket when the backlog's
        estimated drain time exceeds the budget, else enqueue as usual."""
        if self._closed:
            raise RuntimeError("server is closed")
        if self._wall_t0 is None:
            self._wall_t0 = time.perf_counter()
        if self._should_shed():
            ticket = self.ticket_cls(self, spec=self.spec)
            ticket._shed = True
            self.stats.shed_counts["overloaded"] = \
                self.stats.shed_counts.get("overloaded", 0) + 1
            obs.registry().counter(
                "mdrq_server_shed_total",
                help="queries shed at admission, by reason",
                reason="overloaded").inc()
            return ticket
        return super().submit(q)

    # -- the device stage ----------------------------------------------------
    @device_stage
    def flush(self, reason: str = "forced") -> int:
        """Device stage of a flush: plan + launch the window, hand the
        in-flight ``PendingBatch`` to the finalizer via the backlog.

        On a launch failure the window is re-queued in order with its
        deadline clock re-anchored — tickets stay resolvable by a later
        flush, exactly like the synchronous server's exception path.
        """
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        queries = [q for q, _, _ in pending]
        t0 = time.perf_counter()
        ready = None
        try:
            with obs_tracing.span("flush", reason=reason,
                                  n_queries=len(pending), stage="device"), \
                    self._launch_stream():
                pb = self.engine.launch_batch(queries, method=self.method,
                                              spec=self.spec)
                if self._streams is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._streams[0])
        except Exception:
            self._pending = pending + self._pending
            self._oldest_t = pending[0][2]
            raise
        launch_s = time.perf_counter() - t0
        for _, ticket, _ in pending:
            ticket._inflight = True
        win = _Window(pending=pending, reason=reason, batch=pb,
                      t_flush=t0, launch_seconds=launch_s, ready=ready)
        self._backlog.put(win)   # blocks when full: backpressure
        self.stats.flush_reasons[reason] = \
            self.stats.flush_reasons.get(reason, 0) + 1
        obs.registry().counter(
            "mdrq_server_flushes_total",
            help="server batch flushes, by trigger", reason=reason).inc()
        return len(pending)

    # -- the finalize stage --------------------------------------------------
    def _copy_stream(self, win: _Window):
        """Context for a window's syncs: the copy stream, after the window's
        launches (and nothing launched since)."""
        if win.ready is None:
            return contextlib.nullcontext()
        copy = self._streams[1]
        copy.wait_event(win.ready)
        return torch.cuda.stream(copy)

    @finalizer_stage
    def _finalize_loop(self) -> None:
        """Finalizer thread: drain windows, sync + finalize + resolve.

        A window whose finalize raises poisons only its own tickets (the
        exception re-raises from each ``result()``); later windows keep
        serving — per-window fault isolation.
        """
        while True:
            win = self._backlog.get()
            if win is None:   # stop sentinel from close()
                self._backlog.task_done()
                return
            t0 = time.perf_counter()
            try:
                with obs_tracing.span("pipeline_finalize",
                                      n_queries=len(win.pending),
                                      stage="finalize"), \
                        self._copy_stream(win):
                    results = win.batch.finalize()
                for (_, ticket, _), res in zip(win.pending, results):
                    ticket._result = res
                    ticket._done = True
                self._record_window(win, results,
                                    time.perf_counter() - t0)
            except Exception as e:
                for _, ticket, _ in win.pending:
                    ticket._error = e
            finally:
                for _, ticket, _ in win.pending:
                    ticket._event.set()
                self._backlog.task_done()

    @finalizer_stage
    def _record_window(self, win: _Window, results: list,
                       fin_s: float) -> None:
        """Stats + query log for one finalized window (the finalizer thread
        is the sole writer of every field it touches here)."""
        stats = self.stats
        bs = win.batch.stats
        kind = self.spec.kind
        methods = win.batch.methods or [self.method] * len(win.pending)
        for (q, _, t_submit), res, meth in zip(win.pending, results, methods):
            queue_s = win.t_flush - t_submit
            # execute latency is the *device-stage* wall — under overlap the
            # whole-flush wall of the sync server would double-count the
            # finalize time of the previous window
            stats.observe_latency(kind, queue_s, win.launch_seconds)
            self.query_log.offer(obs.QueryLogEntry(
                lower=q.lower, upper=q.upper, spec_kind=kind, method=meth,
                result_size=self.spec.result_size(res),
                queue_seconds=queue_s, execute_seconds=win.launch_seconds,
                flush_reason=win.reason, batch_size=len(win.pending)))
        stats.n_queries += len(win.pending)
        stats.spec_counts[kind] = \
            stats.spec_counts.get(kind, 0) + len(win.pending)
        stats.n_batches += 1
        stats.busy_seconds += win.launch_seconds + fin_s
        stats.plan_seconds += bs.plan_seconds
        stats.finalize_seconds += fin_s
        stats.n_results += bs.n_results
        for meth, c in win.batch.method_counts.items():
            stats.method_counts[meth] = stats.method_counts.get(meth, 0) + c
        # wall anchor: first submit -> this finalize; qps divides by this
        if self._wall_t0 is not None:
            stats.wall_seconds = time.perf_counter() - self._wall_t0
        # EWMA of one window's full pipeline cost, for admission control
        total = win.launch_seconds + fin_s
        self._ewma_batch_s = (total if self._ewma_batch_s <= 0.0
                              else 0.8 * self._ewma_batch_s + 0.2 * total)


def serve_pipelined(engine: MDRQEngine, **kwargs) -> PipelinedMDRQServer:
    """Factory: a warmed, double-buffered server over ``engine``.

    ``with serve_pipelined(engine) as srv: ...`` warms up at construction
    and drains + stops the finalizer thread on exit. Keyword arguments are
    ``PipelinedMDRQServer``'s (``max_batch``, ``backlog``,
    ``latency_budget_s``, ``spec``, ``warmup=False`` to skip warmup, ...).
    """
    return PipelinedMDRQServer(engine, **kwargs)

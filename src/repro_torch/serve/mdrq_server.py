"""Throughput-oriented MDRQ serving front end (synchronous window).

Ports the synchronous ``MDRQServer`` of ``repro/serve/mdrq_server.py``: the
batching layer on top of ``MDRQEngine.query_batch``. Incoming queries
accumulate into a pending window and flush as one fused batch when either
trigger fires —

  * the window reaches ``max_batch`` queries, or
  * the oldest pending query has waited ``max_wait_s`` (latency bound).

There are no threads: ``submit`` returns a ``Ticket`` immediately, deadlines
are checked on every submit and on ``poll()`` (the idle-stream flush path an
admission loop calls between arrivals), and ``Ticket.result()`` forces a flush
of whatever is pending. Throughput accumulates in ``ServerStats``.

Tickets resolve to whatever the server's ``ResultSpec`` finalizes to (the
deprecated ``mode="ids"|"count"`` strings still resolve, with a
``DeprecationWarning``). Every
flush records why it fired ("size" | "deadline" | "forced") in
``ServerStats.flush_reasons``, in the metrics registry
(``mdrq_server_flushes_total{reason=...}``) and on the query-log entries;
per-query queue and execute latency land in per-spec-kind histograms.

Ingest (``append`` / ``delete`` / ``compact``) rides the same window: each
call first flushes what is pending (reason "ingest"), so a query submitted
before a write never sees it and one submitted after always does.

The pipelined server (``serve.pipeline``) subclasses this one: it swaps in
its own ticket type (``ticket_cls``) and fills the stats fields only it
writes (``finalize_seconds``, ``wall_seconds``, ``shed_counts``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Union

import numpy as np

from repro_torch import obs
from repro_torch.obs import tracing as obs_tracing
from repro_torch.core.engine import MDRQEngine
from repro_torch.core.types import RangeQuery, ResultSpec, resolve_spec


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted query; ``result()`` flushes if needed."""

    _server: "MDRQServer"
    spec: Optional[ResultSpec] = None
    _result: Any = None
    _done: bool = False

    def result(self) -> Union[np.ndarray, int, float]:
        if not self._done:
            self._server.flush()
        if not self._done:
            raise RuntimeError("flush did not resolve this ticket")
        return self._result


@dataclasses.dataclass
class ServerStats:
    """Cumulative serving statistics (the throughput report)."""

    n_queries: int = 0
    n_batches: int = 0
    busy_seconds: float = 0.0
    # planning share of busy_seconds (BatchStats.plan_seconds summed)
    plan_seconds: float = 0.0
    # host-finalize share (pipelined mode: the finalizer thread's stage wall)
    finalize_seconds: float = 0.0
    # wall clock from first submit to last finalize (pipelined mode only;
    # 0.0 on the synchronous server). Under overlap, summing per-stage times
    # double-counts concurrent work — qps must anchor to real elapsed time.
    wall_seconds: float = 0.0
    n_results: int = 0
    # queries shed by admission control, by reason ("overloaded")
    shed_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # access-path buckets summed over every flushed batch
    method_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # served queries bucketed by result-spec kind ("ids", "count", "topk", ...)
    spec_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # flushes bucketed by trigger ("size" | "deadline" | "forced" | "ingest")
    flush_reasons: dict[str, int] = dataclasses.field(default_factory=dict)
    # ingest calls bucketed by op ("append" | "delete" | "compact")
    ingest_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # per-spec-kind latency histograms: queue (submit -> flush start) and
    # execute (the query's batch execution wall time), observed per query
    queue_latency: dict[str, obs.Histogram] = dataclasses.field(
        default_factory=dict)
    execute_latency: dict[str, obs.Histogram] = dataclasses.field(
        default_factory=dict)

    @property
    def qps(self) -> float:
        """Sustained throughput. Synchronous serving divides by busy time
        (the window only runs while a flush does); pipelined serving divides
        by wall clock — device and finalize stages overlap, so their sum
        exceeds elapsed time and would overstate throughput."""
        denom = self.wall_seconds if self.wall_seconds > 0 \
            else self.busy_seconds
        return self.n_queries / denom if denom > 0 else 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.n_queries / self.n_batches if self.n_batches else 0.0

    @staticmethod
    def _latency_hist(table: dict, stage: str, kind: str) -> obs.Histogram:
        h = table.get(kind)
        if h is None:
            h = table[kind] = obs.Histogram(f"mdrq_{stage}_seconds",
                                            {"kind": kind})
        return h

    def observe_latency(self, kind: str, queue_s: float,
                        execute_s: float) -> None:
        """Record one query's queue + execute latency under its spec kind."""
        self._latency_hist(self.queue_latency, "queue", kind).observe(queue_s)
        self._latency_hist(self.execute_latency, "execute",
                           kind).observe(execute_s)

    def latency_percentiles(self, kind: str) -> dict[str, dict[str, float]]:
        """p50/p95/p99 queue + execute latency (seconds) for one spec kind;
        empty dicts before any query of that kind was served."""
        out: dict[str, dict[str, float]] = {}
        for name, table in (("queue", self.queue_latency),
                            ("execute", self.execute_latency)):
            h = table.get(kind)
            out[name] = h.percentiles((50, 95, 99)) if h is not None else {}
        return out


class MDRQServer:
    """Accumulates queries into batches and drives ``MDRQEngine.query_batch``."""

    # Ticket type ``submit`` hands out — the pipelined subclass swaps in its
    # event-backed ticket without re-implementing admission.
    ticket_cls = Ticket

    def __init__(
        self,
        engine: MDRQEngine,
        max_batch: int = 128,
        max_wait_s: float = 2e-3,
        method: str = "auto",
        spec: Optional[ResultSpec] = None,
        mode: Optional[str] = None,
        query_log_capacity: int = 512,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.method = method
        self.spec = resolve_spec(spec, mode).validate(engine.dataset.m)
        self.stats = ServerStats()
        # bounded uniform sample of everything ever served (obs.QueryLog)
        self.query_log = obs.QueryLog(capacity=query_log_capacity)
        self._pending: list[tuple[RangeQuery, Ticket, float]] = []
        self._oldest_t: float = 0.0

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def reset_stats(self) -> None:
        """Fresh ``ServerStats`` (benchmark passes: drop warmup traffic)."""
        self.stats = ServerStats()

    def submit(self, q: RangeQuery) -> Ticket:
        """Enqueue one query; flushes when a batching trigger fires."""
        if q.m != self.engine.dataset.m:
            # reject poison queries before they enter the window — inside a
            # batch they would fail every co-batched query's flush
            raise ValueError(
                f"query dims {q.m} != dataset dims {self.engine.dataset.m}")
        ticket = self.ticket_cls(self, spec=self.spec)
        now = time.perf_counter()
        if not self._pending:
            self._oldest_t = now
        self._pending.append((q, ticket, now))
        if len(self._pending) >= self.max_batch:
            self.flush(reason="size")
        elif now - self._oldest_t >= self.max_wait_s:
            self.flush(reason="deadline")
        return ticket

    def poll(self) -> int:
        """Deadline check for an *idle* stream: flush iff the oldest pending
        query has waited past ``max_wait_s``. Returns the flushed batch size
        (0 when nothing is due)."""
        if (self._pending
                and time.perf_counter() - self._oldest_t >= self.max_wait_s):
            return self.flush(reason="deadline")
        return 0

    def flush(self, reason: str = "forced") -> int:
        """Execute everything pending as one batch; returns its size."""
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        queries = [q for q, _, _ in pending]
        t0 = time.perf_counter()
        try:
            with obs_tracing.span("flush", reason=reason,
                                  n_queries=len(pending)):
                results = self.engine.query_batch(queries, method=self.method,
                                                  spec=self.spec)
        except Exception:
            # don't lose co-batched queries: put them back (in order) so
            # their tickets remain resolvable after the caller handles the
            # error, and re-anchor the deadline clock to the oldest one
            self._pending = pending + self._pending
            self._oldest_t = pending[0][2]
            raise
        dt = time.perf_counter() - t0
        for (_, ticket, _), res in zip(pending, results):
            ticket._result = res
            ticket._done = True
        kind = self.spec.kind
        batch_stats = self.engine.last_batch_stats
        methods = batch_stats.methods or [self.method] * len(pending)
        for (q, _, t_submit), res, meth in zip(pending, results, methods):
            queue_s = t0 - t_submit
            self.stats.observe_latency(kind, queue_s, dt)
            self.query_log.offer(obs.QueryLogEntry(
                lower=q.lower, upper=q.upper, spec_kind=kind, method=meth,
                result_size=self.spec.result_size(res),
                queue_seconds=queue_s, execute_seconds=dt,
                flush_reason=reason, batch_size=len(pending)))
        self.stats.n_queries += len(pending)
        self.stats.spec_counts[kind] = \
            self.stats.spec_counts.get(kind, 0) + len(pending)
        self.stats.n_batches += 1
        self.stats.busy_seconds += dt
        self.stats.plan_seconds += batch_stats.plan_seconds
        self.stats.n_results += batch_stats.n_results
        for m, c in batch_stats.method_counts.items():
            self.stats.method_counts[m] = self.stats.method_counts.get(m, 0) + c
        self.stats.flush_reasons[reason] = \
            self.stats.flush_reasons.get(reason, 0) + 1
        obs.registry().counter(
            "mdrq_server_flushes_total",
            help="server batch flushes, by trigger", reason=reason).inc()
        return len(pending)

    # -- the ingest plane ---------------------------------------------------
    def append(self, rows) -> np.ndarray:
        """Append rows ((k, m) array-like) -> their assigned int64 ids."""
        return self._ingest("append", lambda: self.engine.append(rows))

    def delete(self, ids) -> int:
        """Tombstone ids -> count of newly deleted rows."""
        return self._ingest("delete", lambda: self.engine.delete(ids))

    def compact(self) -> np.ndarray:
        """Compact the engine's delta -> the old-id -> new-id map."""
        return self._ingest("compact", lambda: self.engine.compact())

    def _ingest(self, op: str, fn):
        self.flush(reason="ingest")
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        size = int(out.size) if isinstance(out, np.ndarray) else int(out)
        # ingest shares the query log (bound-less entries, spec_kind
        # "ingest"), so writes are seen interleaved with reads
        nan_bounds = np.full((self.engine.dataset.m,), np.nan, np.float32)
        self.query_log.offer(obs.QueryLogEntry(
            lower=nan_bounds, upper=nan_bounds, spec_kind="ingest",
            method=op, result_size=size, queue_seconds=0.0,
            execute_seconds=dt, flush_reason="ingest", batch_size=1))
        self.stats.ingest_counts[op] = self.stats.ingest_counts.get(op, 0) + 1
        obs.registry().counter("mdrq_ingest_total",
                               help="server ingest operations, by op",
                               op=op).inc()
        return out

    def serve_all(self, queries: list[RangeQuery]) -> list:
        """Drive a whole workload through the batching window; results come
        back positionally aligned with the input."""
        tickets = []
        for q in queries:
            tickets.append(self.submit(q))
            self.poll()
        self.flush()
        return [t.result() for t in tickets]

"""Bounded, reservoir-sampled query log — the workload sample a learned
access path trains on.

Flood (arxiv 1912.01668) learns its grid layout from the query workload;
``MDRQServer`` keeps exactly that input here: a fixed-capacity uniform
sample over everything ever served (classic reservoir sampling, so the
memory bound holds under unbounded traffic while every query keeps an equal
chance of being retained). Entries also record *how* each query was served —
chosen path, realized result size, queue/execute latency, and which trigger
flushed its batch — so the log doubles as the drift audit's raw material and
distinguishes deadline (idle-stream) flushes from size-triggered ones.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class QueryLogEntry:
    """One served query, as the workload-learning and audit layers see it."""

    lower: np.ndarray              # (m,) query bounds
    upper: np.ndarray
    spec_kind: str                 # result shape served
    method: str                    # access path that executed it
    result_size: int               # realized result magnitude
    queue_seconds: float           # submit -> flush start
    execute_seconds: float         # its batch's execution wall time
    flush_reason: str              # "size" | "deadline" | "forced"
    batch_size: int                # queries co-flushed with it


class QueryLog:
    """Fixed-capacity uniform reservoir over served queries.

    ``offer`` is O(1); after ``n_seen > capacity`` each new entry replaces a
    uniformly random slot with probability ``capacity / n_seen`` — the
    standard reservoir invariant, so ``entries`` is always a uniform sample
    of everything offered. Seeded for reproducibility.
    """

    def __init__(self, capacity: int = 512, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.entries: list[QueryLogEntry] = []
        self.n_seen = 0
        self._rng = random.Random(seed)

    def offer(self, entry: QueryLogEntry) -> bool:
        """Offer one entry; returns True when it was retained."""
        self.n_seen += 1
        if len(self.entries) < self.capacity:
            self.entries.append(entry)
            return True
        j = self._rng.randrange(self.n_seen)
        if j < self.capacity:
            self.entries[j] = entry
            return True
        return False

    def __len__(self) -> int:
        return len(self.entries)

    def by_reason(self, reason: str) -> list[QueryLogEntry]:
        """Entries whose batch was flushed by ``reason`` — e.g. the idle-
        stream ``"deadline"`` flushes, distinguishable from ``"size"``."""
        return [e for e in self.entries if e.flush_reason == reason]

    def bounds(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Stacked (S, m) lower/upper bounds of the sample — the tensor a
        layout learner consumes. None while empty."""
        if not self.entries:
            return None
        return (np.stack([e.lower for e in self.entries]),
                np.stack([e.upper for e in self.entries]))

"""Deterministic training data pipeline with MDRQ sample selection.

Ports ``repro/data/pipeline.py``. Every training sample carries a feature
vector (quality score, length, dedup distance, language score, toxicity,
...) and the pipeline's admission filter is a partial-match MDRQ (3 of the
8 features) run once, at construction, through the port's ``MDRQEngine``
(``scan`` and ``kdtree`` built, ``method="auto"``) on the pipeline's device:
on a card, the planner's pick launches the single-query columnar scan, its
vertical variant or the kd-tree's block visit. The admitted ids and the
query's stats come back through the engine's counted ``ops.device_get``.

The rest is numpy and equals the reference value for value: batches are a
pure function of ``(seed, step)``, so a resume after preemption replays the
exact stream with no state beyond the step counter (checkpointed by the
trainer). A background prefetch thread hides generation latency; its
bounded queue gives back-pressure.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import Dataset, MDRQEngine, RangeQuery

FEATURES = [
    "quality", "length_log", "dedup_dist", "lang_score",
    "toxicity", "perplexity", "domain", "age_days",
]


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_pool: int = 65536          # candidate sample pool size
    seed: int = 0
    filter_query: Optional[dict[int, tuple[float, float]]] = None
    # structure of the synthetic LM stream (gives a learnable distribution)
    zipf_a: float = 1.2
    markov_mix: float = 0.7


def default_filter() -> dict[int, tuple[float, float]]:
    """Admit high-quality, low-toxicity, deduped samples (partial-match
    MDRQ)."""
    return {0: (0.5, 1.0), 2: (0.2, 1.0), 4: (0.0, 0.3)}


class FilteredTokenPipeline:
    """MDRQ-filtered, deterministic, prefetching token pipeline. ``device``
    (None means ``cuda``) holds the admission engine."""

    def __init__(self, cfg: DataConfig, prefetch: int = 4, device=None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        feats = np.stack([
            rng.random(cfg.n_pool),                      # quality
            rng.random(cfg.n_pool),                      # length_log
            rng.random(cfg.n_pool),                      # dedup_dist
            rng.beta(5, 2, cfg.n_pool),                  # lang_score
            rng.beta(1, 8, cfg.n_pool),                  # toxicity
            rng.random(cfg.n_pool),                      # perplexity
            rng.integers(0, 16, cfg.n_pool),             # domain
            rng.random(cfg.n_pool) * 365,                # age_days
        ]).astype(np.float32)
        self.features = Dataset(feats)
        self.engine = MDRQEngine(self.features, structures=("scan", "kdtree"),
                                 device=device)
        fq = cfg.filter_query if cfg.filter_query is not None \
            else default_filter()
        self.query = RangeQuery.partial(len(FEATURES), fq)
        self.admitted = self.engine.query(self.query, method="auto")
        if self.admitted.size == 0:
            raise ValueError("MDRQ filter admitted zero samples")
        self.filter_stats = self.engine.last_stats
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Batch for ``step`` — a pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step)
                                    & 0x7FFFFFFF)
        sample_ids = self.admitted[
            rng.integers(0, self.admitted.size, size=cfg.global_batch)
        ]
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        for b, sid in enumerate(sample_ids):
            toks[b] = self._sample_tokens(int(sid), step, b)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "sample_ids": sample_ids.astype(np.int32),
        }

    def _sample_tokens(self, sid: int, step: int, b: int) -> np.ndarray:
        """Zipf-with-Markov-structure synthetic stream (learnable,
        per-sample)."""
        cfg = self.cfg
        rng = np.random.default_rng((sid * 2_654_435_761 + step * 97 + b)
                                    & 0x7FFFFFFF)
        v = cfg.vocab_size
        draws = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1).astype(np.int64)
        draws = (draws - 1) % v
        toks = np.empty(cfg.seq_len + 1, np.int64)
        toks[0] = draws[0]
        mix = rng.random(cfg.seq_len) < cfg.markov_mix
        for t in range(1, cfg.seq_len + 1):
            # markov component: deterministic successor of the previous token
            toks[t] = (toks[t - 1] * 31 + 7) % v if mix[t - 1] else draws[t]
        return toks.astype(np.int32)

    # ------------------------------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Prefetching iterator from ``start_step`` (exact resume point)."""
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._queue.put(self.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        while True:
            yield self._queue.get()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

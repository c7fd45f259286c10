"""Mutable data plane: delta segment, tombstones, and atomic compaction.

Ports ``repro/core/delta.py``. Every structure is built once over a frozen
``(m, n)`` array; this module is the write path that keeps them right under
live traffic (a static bulk structure plus an in-memory delta):

  * ``MutableDelta`` — the engine's mutable store: an append-only row-major
    buffer of new rows plus copy-on-write tombstone bitmaps over the base
    dataset and the delta itself. Deletes never touch the built structures;
    they only flip a tombstone bit. Every mutation bumps a monotone version
    and the ``mdrq_delta_rows`` / ``mdrq_delta_tombstones`` gauges.
  * ``DeltaView`` — an immutable snapshot handed to the read path. A query
    call snapshots once and executes entirely against the view, so a
    concurrent append/delete cannot tear a batch. Batches at an unchanged
    version receive the *same* view object, so its cached device tensors
    (the columnar delta block, the per-layout base-tombstone vectors) are
    built once per version and device, not once per batch.
  * ``Compactor`` — the merge: ``build()`` constructs a complete new engine
    state (fresh structures over base-minus-tombstones plus live delta rows)
    WITHOUT holding the ingest lock, then ``commit()`` briefly takes the
    lock, folds in whatever ingest raced with the build (late rows re-seed
    the new delta; late tombstones translate through the id map), and swaps
    the engine's state attribute in one assignment. Queries read that
    attribute once per call, so an in-flight batch finishes on the old
    version and the next one sees the new version.

Id space: base rows keep their dataset positions ``[0, n_base)``; appended
rows get ``n_base + j`` in append order. Compaction renumbers — ``compact()``
returns the old -> new id map (``-1`` for tombstoned rows).

Tombstoned *delta* rows are poisoned to ``+inf`` when the view builds its
device block: finite query bounds never match them, so the delta scan needs
no tombstone input. Base tombstones need a device vector (the structures
were built before the deletes), folded into the masks inside the fused ops.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs import tracing as obs_tracing
from repro_torch.core import types as T
from repro_torch.kernels import ops

DELTA_ROWS_GAUGE = "mdrq_delta_rows"
DELTA_TOMBS_GAUGE = "mdrq_delta_tombstones"


class DeltaView:
    """One immutable version of the delta: what a query batch executes against.

    Holds host copies of the delta rows and both tombstone bitmaps, plus
    caches of the device tensors the fused ops consume, keyed by layout and
    device (two engines on two devices may share one view)."""

    __slots__ = ("version", "n_base", "m", "d", "rows", "delta_tomb",
                 "base_tomb", "has_base_tombs", "delta_ids", "_base_cols",
                 "_cm_cache", "_tomb_cache", "_combined")

    def __init__(self, version: int, n_base: int, m: int, rows: np.ndarray,
                 delta_tomb: np.ndarray, base_tomb: np.ndarray,
                 base_cols: np.ndarray):
        self.version = version
        self.n_base = n_base
        self.m = m
        self.rows = rows                      # (d, m) float32, row-major
        self.d = rows.shape[0]
        self.delta_tomb = delta_tomb          # (d,) bool
        self.base_tomb = base_tomb            # (n_base,) bool
        self.has_base_tombs = bool(base_tomb.any())
        self.delta_ids = n_base + np.arange(self.d, dtype=np.int64)
        self._base_cols = base_cols
        self._cm_cache: dict = {}
        self._tomb_cache: dict = {}
        self._combined: Optional[np.ndarray] = None

    @property
    def is_empty(self) -> bool:
        """True iff queries can ignore the delta entirely (fast path)."""
        return self.d == 0 and not self.has_base_tombs

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.base_tomb.nbytes
                   + self.delta_tomb.nbytes)

    # -- device tensors (cached per layout and device) ---------------------
    def device_cm(self, tile_n: int, device) -> Optional[torch.Tensor]:
        """(m_pad, d_pad) columnar block of the delta rows on ``device``, or
        None when the delta holds no rows.

        Padded exactly as ``ops.prepare_columnar`` pads the base (m -> 8
        with 0.0 under match-all bounds, d -> tile_n with +inf never-match),
        so the block rides the same kernels and the same (m_pad, Q) bounds
        as the base data. Tombstoned rows are poisoned to +inf here.
        """
        if self.d == 0:
            return None
        key = (int(tile_n), str(torch.device(device)))
        cm = self._cm_cache.get(key)
        if cm is None:
            cols = np.array(self.rows.T, dtype=np.float32, order="C")  # a copy
            if self.delta_tomb.any():
                cols[:, self.delta_tomb] = np.inf
            padded, _, _ = ops.prepare_columnar(cols, tile_n=tile_n)
            cm = torch.as_tensor(padded, device=device)
            self._cm_cache[key] = cm
        return cm

    def base_tomb_dev(self, n_pad: int, device,
                      perm: Optional[np.ndarray] = None,
                      key=None, shard: Optional[tuple[int, int]] = None
                      ) -> Optional[torch.Tensor]:
        """(n_pad,) int8 base-tombstone vector in a structure's storage
        order on ``device``, or None when no base row is tombstoned.

        ``perm`` maps storage position -> original row id (the tree
        layouts); storage-order layouts (scan, VA-file) omit it and share
        the default ``key``. ``shard=(s, n_local)`` gives shard s's part
        of the vector, positions ``[s * n_local, (s + 1) * n_local)`` (the
        sharded scan's placement); it is cached per shard index, since
        shards may share one device.
        """
        if not self.has_base_tombs:
            return None
        key = (("_id", int(n_pad)) if key is None else key,
               None if shard is None else int(shard[0]),
               str(torch.device(device)))
        arr = self._tomb_cache.get(key)
        if arr is None:
            host = np.zeros(int(n_pad), np.int8)
            if perm is None:
                host[:self.n_base] = self.base_tomb
            else:
                host[:len(perm)] = self.base_tomb[perm]
            if shard is not None:
                s, n_local = shard
                host = host[s * n_local:(s + 1) * n_local].copy()
            arr = torch.as_tensor(host, device=device)
            self._tomb_cache[key] = arr
        return arr

    # -- host-side helpers (per-query rung, spec merges) ---------------------
    def match_delta_ids(self, q: "T.RangeQuery") -> np.ndarray:
        """Global ids of live delta rows matching ``q`` (numpy)."""
        if self.d == 0:
            return np.empty((0,), np.int64)
        mask = T.match_mask_np(np.ascontiguousarray(self.rows.T), q)
        return self.delta_ids[mask & ~self.delta_tomb]

    def combined_cols(self) -> np.ndarray:
        """(m, n_base + d) base columns with the delta appended — the value
        source for host-side spec finalization over combined ids."""
        if self._combined is None:
            if self.d:
                self._combined = np.concatenate(
                    [self._base_cols, np.ascontiguousarray(self.rows.T)],
                    axis=1)
            else:
                self._combined = self._base_cols
        return self._combined

    def host_ctx(self) -> "T.DeltaHostCtx":
        """The context ``ResultSpec.merge_delta`` folds base + delta with."""
        return T.DeltaHostCtx(n=self.n_base, delta_ids=self.delta_ids,
                              base_cols=self._base_cols, delta_rows=self.rows)

    def merge_finalizer(self, spec: "T.ResultSpec", base_finalize,
                        n_queries: int):
        """The finalize of a fused op's (base, delta) payload pair: the base
        half through ``base_finalize``, the delta half through the spec's
        finalizer (local delta coordinates), merged by the spec."""
        d_n, ctx = self.d, self.host_ctx()

        def finalize(host_payload):
            base_host, delta_host = host_payload
            return spec.merge_delta(base_finalize(base_host),
                                    spec.finalize(delta_host, n_queries, d_n),
                                    ctx)
        return finalize


class MutableDelta:
    """Append-only delta segment + tombstone bitmaps over one base dataset.

    Thread-safe: mutations and snapshots serialize on an internal lock; the
    engine also serializes mutations against compaction commits with its
    ingest lock. Readers go through ``snapshot()``.
    """

    def __init__(self, dataset: "T.Dataset"):
        self.n_base = int(dataset.n)
        self.m = int(dataset.m)
        self._base_cols = dataset.cols
        self._lock = threading.Lock()
        self._rows = np.empty((0, self.m), np.float32)
        self._d = 0
        self._base_tomb = np.zeros(self.n_base, dtype=bool)
        self._delta_tomb = np.zeros(0, dtype=bool)
        self._version = 0
        self._view: Optional[DeltaView] = None
        reg = obs.registry()
        self._rows_gauge = reg.gauge(
            DELTA_ROWS_GAUGE, help="rows in the delta segment (incl. "
            "tombstoned, pending compaction)")
        self._tombs_gauge = reg.gauge(
            DELTA_TOMBS_GAUGE, help="tombstones pending compaction "
            "(base + delta)")
        self._publish_gauges()

    @property
    def d(self) -> int:
        return self._d

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_total(self) -> int:
        """One past the largest currently valid id."""
        return self.n_base + self._d

    @property
    def nbytes(self) -> int:
        """Delta rows + both tombstone bitmaps (the memory_report entry)."""
        with self._lock:
            return int(self._rows[: self._d].nbytes + self._base_tomb.nbytes
                       + self._delta_tomb[: self._d].nbytes)

    def _publish_gauges(self) -> None:
        self._rows_gauge.set(self._d)
        self._tombs_gauge.set(int(self._base_tomb.sum())
                              + int(self._delta_tomb[: self._d].sum()))

    def append(self, rows) -> np.ndarray:
        """Append row(s); returns their new global ids (``n_base + j``)."""
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.m:
            raise ValueError(
                f"appended rows must be (k, {self.m}), got {rows.shape}")
        k = rows.shape[0]
        with self._lock:
            need = self._d + k
            if need > self._rows.shape[0]:
                cap = max(64, 2 * self._rows.shape[0], need)
                grown = np.empty((cap, self.m), np.float32)
                grown[: self._d] = self._rows[: self._d]
                self._rows = grown
                tomb = np.zeros(cap, dtype=bool)
                tomb[: self._d] = self._delta_tomb[: self._d]
                self._delta_tomb = tomb
            self._rows[self._d:need] = rows
            ids = self.n_base + np.arange(self._d, need, dtype=np.int64)
            self._d = need
            self._version += 1
            self._publish_gauges()
            return ids

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta). Idempotent per id; returns how many
        rows were newly tombstoned. Ids must be valid in the current version
        (compaction renumbers — translate through its id map first)."""
        ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        if ids.size == 0:
            return 0
        with self._lock:
            if ids[0] < 0 or ids[-1] >= self.n_base + self._d:
                raise ValueError(
                    f"delete ids out of range [0, {self.n_base + self._d})")
            base = ids[ids < self.n_base]
            dloc = ids[ids >= self.n_base] - self.n_base
            newly = (int((~self._base_tomb[base]).sum())
                     + int((~self._delta_tomb[dloc]).sum()))
            self._base_tomb[base] = True
            self._delta_tomb[dloc] = True
            self._version += 1
            self._publish_gauges()
            return newly

    def snapshot(self) -> DeltaView:
        """The current version as an immutable view — the *same* object
        while the version is unchanged, so per-version device caches are
        shared across batches."""
        with self._lock:
            v = self._view
            if v is not None and v.version == self._version:
                return v
            view = DeltaView(
                version=self._version, n_base=self.n_base, m=self.m,
                rows=self._rows[: self._d].copy(),
                delta_tomb=self._delta_tomb[: self._d].copy(),
                base_tomb=self._base_tomb.copy(),
                base_cols=self._base_cols)
            self._view = view
            return view


class Compactor:
    """Two-phase merge of base + delta into a fresh engine state.

    ``build()`` runs lock-free against a delta snapshot — rebuilding every
    structure happens while ingest and serving continue on the old version.
    ``commit()`` takes the engine's ingest lock only long enough to fold in
    ingest that raced with the build and swap the state attribute.

    ``commit()`` returns the full old -> new id map (length ``n_base + d`` at
    commit time; ``-1`` marks tombstoned rows). ``MDRQEngine.compact()`` is
    the one-shot form.
    """

    def __init__(self, engine):
        self.engine = engine
        self._old_state = None
        self._view: Optional[DeltaView] = None
        self._new_state = None
        self._id_map: Optional[np.ndarray] = None

    def build(self) -> "Compactor":
        """Merge the snapshot into a brand-new state (no locks held)."""
        with obs_tracing.span("build"):
            eng = self.engine
            state = eng._state
            view = state.delta.snapshot()
            keep_base = ~view.base_tomb
            keep_delta = ~view.delta_tomb
            parts = [state.dataset.cols[:, keep_base]]
            if view.d:
                parts.append(np.ascontiguousarray(view.rows[keep_delta].T))
            new_cols = np.ascontiguousarray(
                np.concatenate(parts, axis=1).astype(np.float32))
            if new_cols.shape[1] == 0:
                raise ValueError("compaction would produce an empty dataset; "
                                 "keep at least one live row")
            n_keep_base = int(keep_base.sum())
            id_map = np.full(view.n_base + view.d, -1, dtype=np.int64)
            id_map[: view.n_base][keep_base] = np.arange(n_keep_base)
            if view.d:
                id_map[view.n_base:][keep_delta] = (
                    n_keep_base + np.arange(int(keep_delta.sum())))
            self._new_state = eng._build_state(T.Dataset(new_cols),
                                               version=state.version + 1)
            self._old_state = state
            self._view = view
            self._id_map = id_map
        return self

    def commit(self) -> np.ndarray:
        """Fold in post-snapshot ingest, swap the engine state atomically."""
        if self._new_state is None:
            raise RuntimeError("Compactor.commit() before build()")
        eng = self.engine
        view = self._view
        with obs_tracing.span("commit"), eng._ingest_lock:
            if eng._state is not self._old_state:
                raise RuntimeError("engine state changed during compaction "
                                   "build; re-run build()")
            delta = self._old_state.delta
            with delta._lock:
                d_now = delta._d
                late_rows = delta._rows[view.d:d_now].copy()
                base_tomb_now = delta._base_tomb.copy()
                delta_tomb_now = delta._delta_tomb[:d_now].copy()
            id_map = self._id_map
            new_state = self._new_state
            # Tombstones that landed after the snapshot on rows the merge
            # kept: translate them into the new id space and re-apply them
            # as tombstones of the new state.
            late_dead = np.concatenate([
                np.nonzero(base_tomb_now & ~view.base_tomb)[0],
                view.n_base + np.nonzero(
                    delta_tomb_now[: view.d] & ~view.delta_tomb)[0],
            ])
            if late_dead.size:
                mapped = id_map[late_dead]
                new_state.delta.delete(mapped[mapped >= 0])
                id_map[late_dead] = -1
            full_map = np.concatenate(
                [id_map, np.full(d_now - view.d, -1, np.int64)])
            if d_now > view.d:
                # Rows appended during the build re-seed the new delta.
                new_ids = new_state.delta.append(late_rows)
                full_map[view.n_base + view.d:] = new_ids
                dead_late = delta_tomb_now[view.d:]
                if dead_late.any():
                    new_state.delta.delete(new_ids[dead_late])
                    full_map[view.n_base + view.d:][dead_late] = -1
            eng._state = new_state
            obs.registry().counter(
                "mdrq_compactions_total",
                help="completed delta compactions (atomic state swaps)").inc()
            new_state.delta._publish_gauges()
            self._new_state = None
            return full_map

"""Shared machinery for the blocked (two-phase) indexes on the card.

Ports ``repro/core/blockindex.py``. Both tree indexes — the blocked kd-tree
and the packed STR R*-tree — reduce at query time to the same two-phase plan:

  phase 1 (prune):  vectorized MBR-overlap tests over a small hierarchy of
                    per-block bounding boxes (torch ops, one counted op);
  phase 2 (refine): the visit kernel scans *only* the surviving leaf blocks
                    (one thread block per surviving (query, block) pair, so
                    pruned blocks cost nothing).

What distinguishes the structures is the *build*: how objects are permuted
into leaf blocks (median splits vs sort-tile-recursive vs storage order).
The VA-file's phase 2 reuses ``launch_visits_batch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.kernels import ops


def build_hierarchy(
    leaf_lo: np.ndarray, leaf_hi: np.ndarray, fanout: int = 64
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Build MBR levels bottom-up from leaf MBRs.

    Args:
      leaf_lo, leaf_hi: (m, n_leaves) per-leaf bounding boxes (columnar).
      fanout: children per inner node.

    Returns:
      Levels from root to leaves: [(lo, hi), ...] each (m, n_nodes_level).
    """
    levels = [(leaf_lo, leaf_hi)]
    lo, hi = leaf_lo, leaf_hi
    while lo.shape[1] > 1:
        n_nodes = lo.shape[1]
        n_up = -(-n_nodes // fanout)
        pad = n_up * fanout - n_nodes
        lo_p = np.pad(lo, ((0, 0), (0, pad)), constant_values=np.inf)
        hi_p = np.pad(hi, ((0, 0), (0, pad)), constant_values=-np.inf)
        lo = lo_p.reshape(lo.shape[0], n_up, fanout).min(axis=2)
        hi = hi_p.reshape(hi.shape[0], n_up, fanout).max(axis=2)
        levels.append((lo, hi))
        if n_up == 1:
            break
    return levels[::-1]  # root first


def _prune(levels_lo, levels_hi, qlo: torch.Tensor, qhi: torch.Tensor,
           fanout: int) -> torch.Tensor:
    """Top-down vectorized MBR pruning.

    Args:
      levels_lo/hi: root-first tuples of (m, n_nodes) MBR bounds.
      qlo, qhi: (m, Q) query bounds, one column per query.

    Returns:
      (Q, n_leaves) bool — per-query leaf survivors.
    """
    active = None
    for lo, hi in zip(levels_lo, levels_hi):
        overlap = torch.logical_and(hi[:, None, :] >= qlo[:, :, None],
                                    lo[:, None, :] <= qhi[:, :, None]
                                    ).all(dim=0)  # (Q, n_nodes)
        if active is None:
            active = overlap
        else:
            parents = active.repeat_interleave(fanout, dim=1)[:, : overlap.shape[1]]
            active = torch.logical_and(parents, overlap)
    return active


def _prune_hierarchy(levels_lo, levels_hi, qlo, qhi, fanout: int) -> torch.Tensor:
    return _prune(levels_lo, levels_hi, qlo, qhi, fanout)[0]


prune_hierarchy = ops.counted(
    "prune_hierarchy",
    "Phase-1 MBR hierarchy prune for one query ((m, 1) bounds) -> "
    "(n_leaves,) bool survivors.",
)(_prune_hierarchy)

prune_hierarchy_batch = ops.counted(
    "prune_hierarchy_batch",
    "Batched phase-1 MBR hierarchy prune: every query of a batch in one "
    "vectorized op -> (Q, n_leaves) bool survivors.",
)(_prune)


_next_pow2 = T.next_pow2


def _pad_visit_list(
    query_ids: np.ndarray, block_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a flattened (query, block) visit list to a pow2 bucket.

    Padding rows carry query 0 / block -1 — the visit kernel clamps negative
    block ids to 0, so callers must drop (ids mode) or zero out (count mode)
    the padding rows' output.
    """
    n_visit = _next_pow2(query_ids.size)
    qids_p = np.zeros((n_visit,), np.int32)
    bids_p = np.full((n_visit,), -1, np.int32)
    qids_p[: query_ids.size] = query_ids
    bids_p[: block_ids.size] = block_ids
    return qids_p, bids_p


def _build_visit_index(query_ids: np.ndarray, n_queries: int,
                       n_visit_pad: int) -> np.ndarray:
    """(n_queries, M) table of padded-visit row indices per query.

    M is the pow2-padded maximum visit count of any query; empty slots point
    at row ``n_visit_pad`` — the fill row the visit reducers append. One
    argsort pass, no Python loop over queries. A query's visits keep their
    list order (ascending block id), which the top-k's tie order relies on.
    """
    counts = np.bincount(query_ids, minlength=n_queries)
    m_vis = _next_pow2(max(int(counts.max(initial=0)), 1))
    index = np.full((n_queries, m_vis), n_visit_pad, np.int32)
    order = np.argsort(query_ids, kind="stable")
    starts = np.zeros(n_queries + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(query_ids.size) - starts[query_ids[order]]
    index[query_ids[order], slots] = order.astype(np.int32)
    return index


def reduce_visits_batch(data_dev: torch.Tensor, query_ids: np.ndarray,
                        block_ids: np.ndarray, batch: T.QueryBatch,
                        tile_n: int, n_queries: int, spec: T.ResultSpec,
                        n: int, perm: np.ndarray | None = None,
                        backend: str = "auto", delta=None) -> list:
    """Phase 2 of every batched two-phase path, under any ResultSpec: one
    ``ops.multi_visit_reduce`` launch, one host sync of its payload, then
    the spec's visit finalizer.

    ``delta`` (a ``core.delta.DeltaView``) rides the same op: base
    tombstones gather per visited block and fold into the visit masks, the
    delta block scans with the batch's bounds, and the spec merges the
    halves."""
    payload, fin = launch_visits_batch(data_dev, query_ids, block_ids, batch,
                                       tile_n, n_queries, spec, n, perm=perm,
                                       backend=backend, delta=delta)
    return fin(ops.device_get(payload) if payload is not None else None)


def launch_visits_batch(data_dev: torch.Tensor, query_ids: np.ndarray,
                        block_ids: np.ndarray, batch: T.QueryBatch,
                        tile_n: int, n_queries: int, spec: T.ResultSpec,
                        n: int, perm: np.ndarray | None = None,
                        backend: str = "auto", delta=None) -> tuple:
    """Device half of ``reduce_visits_batch``: one launch, no host sync.

    Returns ``(payload, finalize)``; the caller owns the single counted
    ``ops.device_get(payload)`` and hands its host value to ``finalize``.
    ``payload`` is ``None`` (the host value ignored) when nothing pruned
    through on a frozen dataset — that corner has no device work at all.
    """
    dev = data_dev.device
    dview = delta if delta is not None and not delta.is_empty else None
    dcm = dview.device_cm(tile_n, dev) if dview is not None else None
    if query_ids.size == 0:
        base = [spec.empty_result(n) for _ in range(n_queries)]
        if dcm is None:
            return None, lambda _host: base
        # Nothing pruned through, but the delta still has to be scanned:
        # this corner pays one delta-only launch (none on a frozen dataset).
        lo_d, up_d = ops.batch_bounds_device(batch, dcm.shape[0], dcm.dtype,
                                             dev, q_pad=_next_pow2(len(batch)))
        payload = ops.multi_scan_reduce(
            dcm, lo_d, up_d, spec=spec, tile_n=tile_n, m=dview.m,
            rows=int(batch.dims_mask.any(axis=0).sum()), backend=backend)
        merge = dview.merge_finalizer(spec, lambda _host: base, n_queries)
        return payload, lambda host_payload: merge((None, host_payload))
    tomb = None
    if dview is not None:
        # Tombstones in the structure's storage order: the trees' permuted
        # leaf order (one cached vector per permutation), the VA-file's
        # storage order (shared with the scan's).
        key = None if perm is None else ("perm", id(perm),
                                         int(data_dev.shape[1]))
        tomb = dview.base_tomb_dev(data_dev.shape[1], dev, perm=perm, key=key)
    qids_p, bids_p = _pad_visit_list(query_ids, block_ids)
    q_bucket = _next_pow2(max(n_queries, 1))  # pow2 bounds launch shapes
    # The per-query visit-index table only feeds the reducers that gather by
    # query; every other spec gets a (1, 1) placeholder.
    if spec.needs_visit_index:
        visit_index = _build_visit_index(query_ids.astype(np.int64), q_bucket,
                                         qids_p.size)
    else:
        visit_index = np.zeros((1, 1), np.int32)
    lo_d, up_d = ops.batch_bounds_device(batch, data_dev.shape[0],
                                         data_dev.dtype, dev,
                                         q_pad=_next_pow2(len(batch)))
    payload = ops.multi_visit_reduce(
        data_dev, ops.upload(qids_p, dev), ops.upload(bids_p, dev),
        ops.upload((bids_p >= 0).astype(np.int32), dev),
        ops.upload(visit_index, dev), lo_d, up_d, dcm, tomb,
        spec=spec, tile_n=tile_n, n_queries=q_bucket,
        m=dview.m if dcm is not None else None, backend=backend)
    vctx = T.VisitHostCtx(
        qids=query_ids.astype(np.int32), bids=block_ids.astype(np.int32),
        tile_n=tile_n, n=n, n_queries=n_queries, perm=perm)

    def finalize(host_payload):
        return spec.finalize_visits(host_payload, vctx)
    if dcm is None:
        return payload, finalize
    return payload, dview.merge_finalizer(spec, finalize, n_queries)


def scatter_visit_results(
    masks: np.ndarray,
    query_ids: np.ndarray,
    block_ids: np.ndarray,
    n_queries: int,
    tile_n: int,
    n: int,
    perm: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Turn (V, tile_n) visit masks back into per-query sorted id arrays.

    Each visit row holds the match mask of one (query, block) pair; positions
    map through ``perm`` (when the structure permuted objects) and object
    padding drops. Visit rows are grouped by query with one argsort +
    searchsorted pass.
    """
    results: list[np.ndarray] = [np.empty((0,), np.int64) for _ in range(n_queries)]
    offsets = np.arange(tile_n)
    order = np.argsort(query_ids, kind="stable")
    qids_sorted = query_ids[order]
    bounds = np.searchsorted(qids_sorted, np.arange(n_queries + 1))
    for k in range(n_queries):
        rows = order[bounds[k]: bounds[k + 1]]
        if rows.size == 0:
            continue
        pos = block_ids[rows][:, None] * tile_n + offsets[None, :]
        pos = pos[masks[rows] > 0]
        pos = pos[pos < n]
        if perm is not None:
            pos = perm[pos]
        results[k] = np.sort(pos).astype(np.int64)
    return results


@dataclasses.dataclass
class BlockedIndex:
    """A built blocked index (query side shared by kd-tree / R*-tree).

    Attributes:
      name: structure name ("kdtree" | "rstar").
      data_dev: (m_pad, n_pad) permuted columnar data on the device.
      perm: (n,) original object id of each permuted position.
      levels_lo/hi: root-first MBR hierarchy, device tensors.
      tile_n: leaf block size (objects per leaf).
      m, n: logical sizes.
    """

    name: str
    data_dev: torch.Tensor
    perm: np.ndarray
    levels_lo: tuple[torch.Tensor, ...]
    levels_hi: tuple[torch.Tensor, ...]
    fanout: int
    tile_n: int
    m: int
    n: int
    backend: str = "auto"

    # -- stats of the last query (for benchmarks / planner calibration) --
    last_visited_blocks: int = 0

    @property
    def n_leaves(self) -> int:
        return self.data_dev.shape[1] // self.tile_n

    @property
    def nbytes_index(self) -> int:
        """Extra memory vs a plain scan (MBR hierarchy; paper §7.2 metric)."""
        return sum(int(np.prod(l.shape)) * 4 * 2 for l in self.levels_lo)

    def query_leaf_mask(self, q: T.RangeQuery) -> np.ndarray:
        """Phase 1: (n_leaves,) bool survivors of the hierarchy prune."""
        qlo, qhi = ops.query_bounds_device(q, self.m, torch.float32,
                                           self.data_dev.device)
        mask = prune_hierarchy(self.levels_lo, self.levels_hi, qlo, qhi,
                               fanout=self.fanout)
        return ops.device_get(mask)

    def _visit_one(self, q: T.RangeQuery) -> tuple[np.ndarray, torch.Tensor | None]:
        """Prune, then scan the surviving leaves -> (survivors, (v, tile_n)
        device masks, or None when nothing survived)."""
        survivors = np.nonzero(self.query_leaf_mask(q))[0].astype(np.int32)
        self.last_visited_blocks = int(survivors.size)
        if survivors.size == 0:
            return survivors, None
        # Pad the visit list to a pow2 bucket to bound the launch shapes.
        ids = np.full((_next_pow2(survivors.size),), -1, np.int32)
        ids[: survivors.size] = survivors
        qlo, qhi = ops.query_bounds_device(q, self.data_dev.shape[0],
                                           self.data_dev.dtype,
                                           self.data_dev.device)
        masks = ops.range_scan_visit(
            self.data_dev, ops.upload(ids, self.data_dev.device),
            qlo, qhi, tile_n=self.tile_n, backend=self.backend)
        return survivors, masks[: survivors.size]  # padding visits drop

    def query(self, q: T.RangeQuery) -> np.ndarray:
        """Full query -> sorted original ids of matching objects."""
        survivors, masks = self._visit_one(q)
        if masks is None:
            return np.empty((0,), np.int64)
        masks = ops.device_get(masks)  # (v, tile_n)
        # Map (block, offset) -> permuted position -> original id.
        pos = (survivors[:, None] * self.tile_n + np.arange(self.tile_n)[None, :])
        pos = pos[masks > 0]
        pos = pos[pos < self.n]  # drop object padding
        return np.sort(self.perm[pos]).astype(np.int64)

    def count(self, q: T.RangeQuery) -> int:
        """Count-only query: visit masks are summed on the device (counts are
        permutation-invariant, so ``perm`` never enters)."""
        _, masks = self._visit_one(q)
        if masks is None:
            return 0
        return int(ops.device_get(masks.ne(0).sum()))

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        """Device half of the batched two-phase query -> (payload, finalize).

        The prune is a mid-stage sync (the surviving (query, block) pairs
        decide the visit launch's shapes), so it runs here along with the
        fused visit launch; ``finalize`` defers the payload sync and the
        spec's host finalizer to the caller. ``payload`` is None when nothing
        pruned through on a frozen dataset. ``delta`` rides the visit op
        (see ``launch_visits_batch``).
        """
        spec = T.resolve_spec(spec).validate(self.m)
        q_n = len(batch)
        q_pad = _next_pow2(q_n)  # pow2 query bucket bounds launch shapes
        qlo, qhi = batch.bounds_columnar(self.m, q_pad)
        dev = self.data_dev.device
        leaf_mask = ops.device_get(prune_hierarchy_batch(
            self.levels_lo, self.levels_hi, ops.upload(qlo, dev),
            ops.upload(qhi, dev), fanout=self.fanout,
        ))[:q_n]  # (Q, n_leaves); padding queries are match-all -> dropped
        qids, bids = np.nonzero(leaf_mask)
        self.last_visited_blocks = int(qids.size)
        return launch_visits_batch(
            self.data_dev, qids.astype(np.int32), bids.astype(np.int32),
            batch, self.tile_n, q_n, spec, self.n, perm=self.perm,
            backend=self.backend, delta=delta)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> list:
        """Batched two-phase query: one counted prune (+ its survivor-mask
        sync) + one fused visit launch (+ its payload sync). Positions map
        through ``perm`` in the spec's finalizer."""
        payload, fin = self.launch_batch(batch, spec=spec, delta=delta)
        return fin(ops.device_get(payload) if payload is not None else None)


def finish_build(
    name: str,
    cols_perm: np.ndarray,
    perm: np.ndarray,
    tile_n: int,
    fanout: int,
    *,
    device,
    backend: str = "auto",
) -> BlockedIndex:
    """Common tail of every build: pad, compute leaf MBRs, build the
    hierarchy, place it on ``device``.

    Args:
      cols_perm: (m, n) columnar data already permuted into leaf order.
      perm: (n,) original id per permuted position.
    """
    m, n = cols_perm.shape
    padded, _, _ = ops.prepare_columnar(cols_perm, tile_n=tile_n)
    n_leaves = padded.shape[1] // tile_n
    blocks = padded[:m].reshape(m, n_leaves, tile_n)
    # +inf object padding poisons MBR lows/highs of the last block; mask it.
    leaf_lo = np.where(np.isposinf(blocks), np.inf, blocks).min(axis=2)
    leaf_hi = np.where(np.isposinf(blocks), -np.inf, blocks).max(axis=2)
    levels = build_hierarchy(leaf_lo, leaf_hi, fanout=fanout)
    return BlockedIndex(
        name=name,
        data_dev=torch.as_tensor(padded, device=device),
        perm=np.asarray(perm),
        levels_lo=tuple(torch.as_tensor(lo, device=device) for lo, _ in levels),
        levels_hi=tuple(torch.as_tensor(hi, device=device) for _, hi in levels),
        fanout=fanout,
        tile_n=tile_n,
        m=m,
        n=n,
        backend=ops.check_backend(backend),
    )

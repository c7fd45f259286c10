"""VA-file (the paper's §2.2.3 / §5.3).

Ports ``repro/core/vafile.py``. The VA-file is a branch-free two-phase scan:

  * build: quantize every dimension to 2 bits (4 cells, the paper's static
    ``b_j = 2``), boundaries equal-width over the observed domain (the
    paper's choice);
  * phase 1: the packed filter kernel compares the approximations (16 dims
    per int32 word) against the approximated query — integers instead of
    floats, 16x fewer bytes than the exact scan;
  * phase 2: leaf blocks holding at least one candidate are refined with the
    exact visit kernel. Blocks with no candidate are never touched — the
    paper's "buckets whose approximation intersects".

Unlike the trees, data stays in storage order (no permutation), so the
engine's VA-file refines against the columnar scan's device copy.

Batched execution runs both phases once per batch: one ``multi_va_filter``
whose candidate masks reduce on the device to per-(query, block) survivor
bits — one small (Q, n_blocks) bool readback — and one
``multi_visit_reduce`` over the surviving pairs, exactly like the trees.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.kernels import ops
from repro_torch.kernels.va_filter import BITS_PER_DIM, pack_codes

# Cells per dimension, derived from the kernel's bit width (paper §2.2.3:
# static b_j = 2 -> 4 cells). The planner's VA cost derives its slack and
# word counts from here too — one constant governs build, kernel and plan.
CELLS = 1 << BITS_PER_DIM


_next_pow2 = T.next_pow2


@dataclasses.dataclass
class VAFile:
    """A built VA-file instance."""

    data_dev: torch.Tensor    # (m_pad, n_pad) exact columnar data, storage order
    packed_dev: torch.Tensor  # (w, n_pad) int32 packed 2-bit approximations
    boundaries: np.ndarray    # (m, CELLS - 1) inner cell boundaries per dim
    tile_n: int
    m: int
    n: int
    backend: str = "auto"

    last_candidate_frac: float = 0.0
    last_visited_blocks: int = 0

    @property
    def nbytes_index(self) -> int:
        """Approximation storage (the VA-file's memory cost vs a plain scan)."""
        return int(np.prod(self.packed_dev.shape)) * 4

    @property
    def _m_sublane(self) -> int:
        return -(-self.m // 8) * 8

    @property
    def _device(self) -> torch.device:
        return self.data_dev.device

    def query_cells(self, q: T.RangeQuery) -> tuple[np.ndarray, np.ndarray]:
        """Approximate the query: per-dim [cell_lo, cell_hi] intersected cells."""
        cell_lo = np.zeros((self.m,), np.int32)
        cell_hi = np.full((self.m,), CELLS - 1, np.int32)
        for d in range(self.m):
            b = self.boundaries[d]
            # cell of x = #boundaries <= x  (boundaries are inner edges)
            cell_lo[d] = np.searchsorted(b, q.lower[d], side="right") if np.isfinite(q.lower[d]) else 0
            cell_hi[d] = np.searchsorted(b, q.upper[d], side="right") if np.isfinite(q.upper[d]) else CELLS - 1
        return cell_lo, cell_hi

    def query_cells_batch(self, batch: T.QueryBatch, q_pad: int | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Query-minor (m_s, q_pad or Q) cell bounds for the batched filter.

        Sublane-padded rows — and padding query columns beyond Q — carry
        [0, CELLS-1] match-all bounds (padding queries' rows are dropped by
        the caller). Per-query values are identical to ``query_cells``:
        ``searchsorted`` maps -inf to cell 0 and +inf to the last cell.
        """
        q_n = len(batch)
        width = q_pad or q_n
        cell_lo = np.zeros((self._m_sublane, width), np.int32)
        cell_hi = np.full((self._m_sublane, width), CELLS - 1, np.int32)
        for d in range(self.m):
            b = self.boundaries[d]
            cell_lo[d, :q_n] = np.searchsorted(b, batch.lower[:, d], side="right")
            cell_hi[d, :q_n] = np.searchsorted(b, batch.upper[:, d], side="right")
        return cell_lo, cell_hi

    def query(self, q: T.RangeQuery) -> np.ndarray:
        """Two-phase query -> sorted matching object ids."""
        survivors = self._candidate_blocks(q)
        self.last_visited_blocks = int(survivors.size)
        if survivors.size == 0:
            return np.empty((0,), np.int64)
        masks = ops.device_get(self._refine(survivors, q))
        pos = survivors[:, None] * self.tile_n + np.arange(self.tile_n)[None, :]
        pos = pos[masks > 0]
        return np.sort(pos[pos < self.n]).astype(np.int64)

    def count(self, q: T.RangeQuery) -> int:
        """Count-only query: refinement masks are summed on the device (object
        padding is +inf and never survives the exact compare)."""
        survivors = self._candidate_blocks(q)
        self.last_visited_blocks = int(survivors.size)
        if survivors.size == 0:
            return 0
        return int(ops.device_get(self._refine(survivors, q).ne(0).sum()))

    def _refine(self, survivors: np.ndarray, q: T.RangeQuery) -> torch.Tensor:
        """Phase 2: exact visit scan of the surviving blocks -> (v, tile_n)
        device masks."""
        ids = np.full((_next_pow2(survivors.size),), -1, np.int32)
        ids[: survivors.size] = survivors
        qlo_f, qhi_f = ops.query_bounds_device(q, self.data_dev.shape[0],
                                               self.data_dev.dtype, self._device)
        masks = ops.range_scan_visit(self.data_dev,
                                     torch.as_tensor(ids, device=self._device),
                                     qlo_f, qhi_f, tile_n=self.tile_n,
                                     backend=self.backend)
        return masks[: survivors.size]  # padding visits (id -1) drop

    def _candidate_blocks(self, q: T.RangeQuery) -> np.ndarray:
        """Phase 1 for one query: block ids containing >= 1 VA candidate."""
        cell_lo, cell_hi = self.query_cells(q)
        m_s = self._m_sublane
        qlo = np.zeros((m_s, 1), np.int32)
        qhi = np.full((m_s, 1), CELLS - 1, np.int32)
        qlo[: self.m, 0] = cell_lo
        qhi[: self.m, 0] = cell_hi
        cand = ops.device_get(ops.va_filter(
            self.packed_dev, torch.as_tensor(qlo, device=self._device),
            torch.as_tensor(qhi, device=self._device), self.m,
            backend=self.backend,
        )) > 0
        self.last_candidate_frac = float(cand[: self.n].mean())
        n_blocks = self.data_dev.shape[1] // self.tile_n
        block_any = cand[: n_blocks * self.tile_n].reshape(
            n_blocks, self.tile_n).any(axis=1)
        return np.nonzero(block_any)[0].astype(np.int32)

    def _candidate_blocks_batch(self, batch: T.QueryBatch
                                ) -> tuple[np.ndarray, np.ndarray]:
        """Batched phase 1: one fused filter op, one small host sync of the
        (Q, n_blocks) survivor bits."""
        q_n = len(batch)
        q_pad = _next_pow2(q_n)  # pow2 query bucket bounds launch shapes
        cell_lo, cell_hi = self.query_cells_batch(batch, q_pad)
        block_any = ops.multi_va_filter(
            self.packed_dev, torch.as_tensor(cell_lo, device=self._device),
            torch.as_tensor(cell_hi, device=self._device), self.m,
            block_n=self.tile_n, backend=self.backend,
        )
        surv = ops.device_get(block_any)[:q_n]  # padding queries drop
        qids, bids = np.nonzero(surv)
        return qids.astype(np.int32), bids.astype(np.int32)

    def query_batch(self, batch: T.QueryBatch,
                    spec: T.ResultSpec = T.IDS, delta=None) -> list:
        """Batched two-phase query: one filter op (+ its survivor-bits sync)
        and one ``multi_visit_reduce`` carrying the ResultSpec's reducer
        (+ its payload sync)."""
        payload, fin = self.launch_batch(batch, spec=spec, delta=delta)
        return fin(ops.device_get(payload) if payload is not None else None)

    def launch_batch(self, batch: T.QueryBatch,
                     spec: T.ResultSpec = T.IDS, delta=None) -> tuple:
        """Device half of the batched two-phase query -> (payload, finalize).

        Phase 1 (the packed filter + its survivor-bits sync — a
        shape-deciding mid-stage sync, like the trees' prune) and the fused
        visit launch run here; ``finalize`` defers the payload sync and host
        finalizer to the caller. ``payload`` is None when no block survived
        on a frozen dataset. The VA-file keeps storage order, so under a
        ``delta`` it shares the scan's base-tombstone vector.
        """
        from repro_torch.core.blockindex import launch_visits_batch

        spec = T.resolve_spec(spec).validate(self.m)
        q_n = len(batch)
        qids, bids = self._candidate_blocks_batch(batch)
        self.last_visited_blocks = int(qids.size)
        return launch_visits_batch(
            self.data_dev, qids, bids, batch, self.tile_n, q_n, spec,
            self.n, perm=None, backend=self.backend, delta=delta,
        )


def build_vafile(
    dataset: T.Dataset, tile_n: int = 1024, *, data_dev: torch.Tensor,
    backend: str = "auto",
) -> VAFile:
    """Build a VA-file on ``data_dev``'s device.

    Args:
      dataset: columnar dataset.
      tile_n: refinement block size.
      data_dev: the exact data on the device, padded as
        ``ops.prepare_columnar`` pads it at ``tile_n`` — the columnar scan's
        copy, which the VA-file shares (both keep storage order).
    """
    cols = dataset.cols
    m, n = cols.shape
    # equal-width cells over the observed domain (the paper's scheme)
    lo = cols.min(axis=1, keepdims=True)
    hi = cols.max(axis=1, keepdims=True)
    steps = np.arange(1, CELLS)[None, :] / CELLS  # (1, 3)
    boundaries = lo + (hi - lo) * steps  # (m, 3)

    codes = np.zeros((m, n), np.uint8)
    for d in range(m):
        codes[d] = np.searchsorted(boundaries[d], cols[d], side="right").astype(np.uint8)
    packed = pack_codes(codes)
    # Pad objects: word 0 of padding must NOT alias cell 0 matches. The exact
    # data pads with +inf (never matches); approximations may produce false
    # candidates in the padded tail, which the exact refine rejects.
    packed = T.pad_axis(packed, 1, tile_n, 0)
    if data_dev.shape != (-(-m // 8) * 8, packed.shape[1]):
        raise ValueError(f"data_dev {tuple(data_dev.shape)} is not the "
                         f"padded ({m}, {n}) data at tile_n={tile_n}")
    return VAFile(
        data_dev=data_dev,
        packed_dev=torch.as_tensor(packed, device=data_dev.device),
        boundaries=boundaries.astype(np.float32),
        tile_n=tile_n,
        m=m,
        n=n,
        backend=ops.check_backend(backend),
    )

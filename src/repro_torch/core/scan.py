"""Scans (the paper's §3 / §5.4 / §5.5 contestants, on the card).

  * ``ColumnarScan.query``          — complete-match scan over the columnar
    layout through the ``range_scan`` op (all dims fused).
  * ``ColumnarScan.query_partial``  — partial-match scan through
    ``range_scan_vertical``: touches only queried dimensions' rows (the
    paper's vertical-partitioning advantage, §5.5).
  * ``RowScan.query``               — row-major layout scan through
    ``range_scan_rows`` (the paper's horizontal partitioning, §5.4), one
    query per launch; the engine serves it behind ``PerQueryPath``.

Batched execution: ``query_batch`` / ``launch_batch`` evaluate a whole
``QueryBatch`` through one fused multi-query launch that carries the
``ResultSpec``'s on-device reducer (``ops.multi_scan_reduce`` /
``multi_scan_vertical_reduce``), with the query axis padded to a pow2 bucket
so arbitrary batch sizes hit a bounded set of launch shapes. The payload
crosses in one host sync. A ``delta`` (``core.delta.DeltaView``) rides the
same op: base tombstones fold into the masks on the device, the delta block
scans with the same bounds, and the spec merges the two finalized halves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.kernels import ops


def bucketed_batch_bounds(batch: T.QueryBatch, m_pad: int, dtype, device
                          ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """(q_pad, lo, up): pow2-bucketed device bounds for one fused batch launch.

    The query axis rounds up to the next power of two; padding columns are
    match-all and their output rows are dropped by the caller.
    """
    q_pad = T.next_pow2(len(batch))
    lo, up = ops.batch_bounds_device(batch, m_pad, dtype, device, q_pad=q_pad)
    return q_pad, lo, up


@dataclasses.dataclass
class ColumnarScan:
    """Full-scan engine over dimension-major data on one device."""

    data_dev: torch.Tensor  # (m_pad, n_pad)
    m: int
    n: int
    tile_n: int = 1024
    backend: str = "auto"

    @property
    def nbytes_index(self) -> int:
        return 0  # a scan needs no auxiliary structures (paper §8)

    @property
    def m_pad(self) -> int:
        return self.data_dev.shape[0]

    def _bounds(self, q: T.RangeQuery):
        return ops.query_bounds_device(q, self.m_pad, self.data_dev.dtype,
                                       self.data_dev.device)

    def _mask_device(self, q: T.RangeQuery) -> torch.Tensor:
        qlo, qhi = self._bounds(q)
        return ops.range_scan(self.data_dev, qlo, qhi, tile_n=self.tile_n,
                              m=self.m, rows=q.n_queried_dims,
                              backend=self.backend)

    def _mask_partial_device(self, dims: np.ndarray, q: T.RangeQuery
                             ) -> torch.Tensor:
        qlo, qhi = self._bounds(q)
        return ops.range_scan_vertical(
            self.data_dev, ops.dim_ids_device(dims, self.m_pad,
                                              self.data_dev.device),
            qlo, qhi, tile_n=self.tile_n, backend=self.backend)

    def mask(self, q: T.RangeQuery) -> np.ndarray:
        """(n,) bool match mask (complete or partial match)."""
        return ops.device_get(self._mask_device(q))[: self.n] > 0

    def mask_partial(self, q: T.RangeQuery) -> np.ndarray:
        """(n,) bool mask touching only the queried dimensions."""
        dims = np.nonzero(q.dims_mask)[0].astype(np.int32)
        if dims.size == 0:
            return np.ones((self.n,), bool)
        out = self._mask_partial_device(dims, q)
        return ops.device_get(out)[: self.n] > 0

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return np.nonzero(self.mask(q))[0].astype(np.int64)

    def query_partial(self, q: T.RangeQuery) -> np.ndarray:
        return np.nonzero(self.mask_partial(q))[0].astype(np.int64)

    # -- count-only results (device-side reduction, no id materialization) --
    def count(self, q: T.RangeQuery) -> int:
        """Match count from one scan launch + one scalar transfer."""
        return int(ops.device_get(ops.mask_counts(self._mask_device(q))))

    def count_partial(self, q: T.RangeQuery) -> int:
        """Match count touching only the queried dimensions' rows."""
        dims = np.nonzero(q.dims_mask)[0].astype(np.int32)
        if dims.size == 0:
            return self.n
        out = self._mask_partial_device(dims, q)
        return int(ops.device_get(ops.mask_counts(out)))

    # -- batched execution (fused multi-query kernels) ---------------------
    def query_batch(self, batch: T.QueryBatch, partial: bool = False,
                    spec: T.ResultSpec = T.IDS, delta=None) -> list:
        """Batched execution under any ResultSpec: the fused multi-query
        kernel and the spec's on-device reducer run as one launch, the
        payload crosses in one host sync, and the spec's host finalizer
        types the per-query results. ``delta`` folds the mutable plane into
        the same op (see the module docstring)."""
        payload, fin = self.launch_batch(batch, partial=partial, spec=spec,
                                         delta=delta)
        return fin(ops.device_get(payload))

    def launch_batch(self, batch: T.QueryBatch, partial: bool = False,
                     spec: T.ResultSpec = T.IDS, delta=None):
        """Device half of ``query_batch``: issue the one fused launch and
        return ``(payload, finalize)`` without synchronizing.

        ``finalize(host_payload)`` — where ``host_payload`` is the caller's
        single counted ``ops.device_get(payload)`` — runs the spec's host
        finalizer (and, under a delta, the spec's merge).
        """
        spec = T.resolve_spec(spec).validate(self.m)
        dev = self.data_dev.device
        q_pad, lo, up = bucketed_batch_bounds(batch, self.m_pad,
                                              self.data_dev.dtype, dev)
        dcm = tomb = None
        if delta is not None and not delta.is_empty:
            dcm = delta.device_cm(self.tile_n, dev)
            tomb = delta.base_tomb_dev(self.data_dev.shape[1], dev)
        if partial:
            ids = batch.padded_dim_ids(q_pad)
            dim_ids = ops.dim_ids_device(ids, self.m_pad, dev)
            payload = ops.multi_scan_vertical_reduce(
                self.data_dev, dim_ids, lo, up, dcm, tomb, spec=spec,
                tile_n=self.tile_n, m=self.m, rows=int(np.unique(ids).size),
                backend=self.backend)
        else:
            payload = ops.multi_scan_reduce(
                self.data_dev, lo, up, dcm, tomb, spec=spec,
                tile_n=self.tile_n, m=self.m,
                rows=int(batch.dims_mask.any(axis=0).sum()),
                backend=self.backend)
        n_q, n = len(batch), self.n

        def finalize(host_payload):
            return spec.finalize(host_payload, n_q, n)
        if dcm is None:
            return payload, finalize
        return payload, delta.merge_finalizer(spec, finalize, n_q)


def build_columnar_scan(dataset: T.Dataset, tile_n: int = 1024, *,
                        device, backend: str = "auto") -> ColumnarScan:
    """Pad ``dataset`` (``ops.prepare_columnar``) and place it on ``device``."""
    padded, m, n = ops.prepare_columnar(dataset.cols, tile_n=tile_n)
    return ColumnarScan(data_dev=torch.as_tensor(padded, device=device),
                        m=m, n=n, tile_n=tile_n,
                        backend=ops.check_backend(backend))


@dataclasses.dataclass
class RowScan:
    """Row-major layout scan (the paper's horizontal partitioning, §5.4)."""

    data_dev: torch.Tensor  # (n_pad, m_pad)
    m: int
    n: int
    tile_rows: int = 512
    backend: str = "auto"

    @property
    def nbytes_index(self) -> int:
        return 0

    def _mask_device(self, q: T.RangeQuery) -> torch.Tensor:
        qlo, qhi = ops.query_bounds_device(q, self.data_dev.shape[1],
                                           self.data_dev.dtype,
                                           self.data_dev.device)
        return ops.range_scan_rows(self.data_dev, qlo.T, qhi.T,
                                   tile_rows=self.tile_rows,
                                   backend=self.backend)

    def mask(self, q: T.RangeQuery) -> np.ndarray:
        return ops.device_get(self._mask_device(q))[: self.n] > 0

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return np.nonzero(self.mask(q))[0].astype(np.int64)

    def count(self, q: T.RangeQuery) -> int:
        """Match count summed on the device (+inf padding rows never
        match)."""
        return int(ops.device_get(ops.mask_counts(self._mask_device(q))))


def build_row_scan(dataset: T.Dataset, tile_rows: int = 512, *, device,
                   backend: str = "auto") -> RowScan:
    """Pad ``dataset``'s rows (dims to 8 with 0.0 under match-all bounds,
    rows to ``tile_rows`` with +inf) and place them on ``device``."""
    rows = dataset.rows()  # (n, m)
    rows = T.pad_axis(rows, 1, 8, 0.0)
    rows = T.pad_axis(rows, 0, tile_rows, np.inf)
    return RowScan(data_dev=torch.as_tensor(np.ascontiguousarray(rows),
                                            device=device),
                   m=dataset.m, n=dataset.n, tile_rows=tile_rows,
                   backend=ops.check_backend(backend))

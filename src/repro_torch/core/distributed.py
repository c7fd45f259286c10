"""Distributed MDRQ execution — horizontal partitioning over devices.

Ports ``repro/core/distributed.py``. The paper's horizontal partitioning
(§3.1) gives each of t workers n/t objects, runs the same search on each
partition and merges the partial results. Here the workers are the shards of
a ``DataMesh``: an ordered tuple of torch devices along one axis, ``"data"``.
Shard s holds objects ``[s * n_local, (s + 1) * n_local)`` of the padded
columnar array on ``mesh.devices[s]``, and every shard runs the same scan
kernel on its own (m_pad, n_local) block.

One process drives every shard, as the reference's single ``shard_map``
program does: a counted op launches each shard's kernels on its device's
current stream, then the spec's merge (``ResultSpec.distributed_reduce``)
gathers the shards' small partials on the mesh's first device and merges
them there in shard order — sums for counts and ``Agg("sum")``, ``amin`` /
``amax``, one final top-k. No atomics, so repeated calls give the same bits.
Ids and Mask keep the reference's identity: the per-shard masks stay per
shard, cross to the host in the one counted ``ops.device_get`` and are
concatenated there in shard order.

A mesh may list one device several times. The shards then share that card
and nothing moves between them; the partition and merge code is the code D
cards run. (The reference's tests do the same with eight host devices
forced onto one CPU.)

Every entry point is registered through ``ops.counted`` and every
device->host read goes through ``ops.device_get``: a batch costs one
``distributed_multi_reduce`` and one host sync, whatever the mesh size.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.kernels import ops
from repro_torch.kernels import reducers as _red

AXIS = "data"


class DataMesh:
    """An ordered 1-D mesh of torch devices along axis ``"data"``.

    ``devices[s]`` holds shard s. A device may appear several times (virtual
    shards on one card). Hashable, so it can key a counted op's warm set.
    """

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a DataMesh needs at least one device")
        for d in devs:
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "DataMesh lists a CUDA device and no CUDA device is "
                        "available; pass device='cpu' to run the plain "
                        "versions")
                if d.index is not None and d.index >= torch.cuda.device_count():
                    raise ValueError(f"{d} is not present: "
                                     f"{torch.cuda.device_count()} CUDA "
                                     f"device(s)")
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """``{"data": D}``, as the reference's ``Mesh.shape`` reads."""
        return {AXIS: self.size}

    @property
    def first(self) -> torch.device:
        """Where the shards' partials merge."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def replicate(self, t: torch.Tensor) -> dict[torch.device, torch.Tensor]:
        """One copy of ``t`` per distinct device (``t`` itself where it
        already lies) — the reference's replicated ``P()`` inputs."""
        return {d: (t if t.device == d else t.to(d)) for d in self.distinct}

    def gather(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Shard partials -> the same tensors on the first device, in shard
        order. A partial already there does not move; one on another card
        is copied without blocking the host, after the first device's
        current stream waits for the event of the shard's stream."""
        out = []
        for t in parts:
            if t.device == self.first:
                out.append(t)
                continue
            if t.is_cuda and self.first.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(t.device))
                torch.cuda.current_stream(self.first).wait_event(ready)
            out.append(t.to(self.first, non_blocking=True))
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, DataMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]}, axis={AXIS!r})"


def make_data_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """A 1-D ``"data"`` mesh.

    ``device`` is a device type — ``None`` or ``"cuda"`` (the first
    ``n_devices`` cards, all by default) or ``"cpu"`` (the one CPU device)
    — or an explicit sequence of devices, taken as listed; only an explicit
    sequence may repeat a device. Asking for more devices of a type than
    are present raises.
    """
    if device is not None and not isinstance(device, (str, torch.device)):
        devs = list(device)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices "
                             f"listed")
        return DataMesh(devs)
    kind = torch.device("cuda" if device is None else device)
    if kind.index is not None:
        raise ValueError(f"pass a device type or a sequence of devices, not "
                         f"{kind}")
    if kind.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_data_mesh builds a CUDA mesh by default and no CUDA "
                "device is available; pass device='cpu'")
        present = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        present = [kind]
    k = len(present) if n_devices is None else int(n_devices)
    if not 1 <= k <= len(present):
        raise ValueError(
            f"asked for {k} {kind.type} device(s), {len(present)} present; "
            f"list a device several times to place several shards on it")
    return DataMesh(present[:k])


def shard_columnar(mesh: DataMesh, padded_cols: np.ndarray,
                   tile_n: int = 1024) -> tuple[torch.Tensor, ...]:
    """Place (m_pad, n_pad) columnar data sharded over objects: shard s, the
    columns ``[s * n_local, (s + 1) * n_local)``, contiguous on
    ``mesh.devices[s]``.

    n_pad must divide by (D * tile_n) — callers pad with +inf sentinels via
    ``ops.prepare_columnar`` at tile_n * D, so the sentinels sit in the last
    shard(s) and never match.
    """
    d = mesh.size
    m_pad, n_pad = padded_cols.shape
    if n_pad % (d * tile_n):
        raise ValueError(f"n_pad={n_pad} is not a multiple of {d} shards x "
                         f"tile_n={tile_n}")
    n_local = n_pad // d
    return tuple(
        torch.as_tensor(np.ascontiguousarray(
            padded_cols[:, s * n_local:(s + 1) * n_local]), device=dev)
        for s, dev in enumerate(mesh.devices))


def concat_shards(host_parts) -> np.ndarray:
    """Host per-shard arrays (last axis = objects) -> one array in shard
    order: the sharded payload's host half."""
    return np.concatenate(host_parts, axis=-1)


# -- shard bodies ---------------------------------------------------------------

def _on_first_device(fn):
    """Run a mesh op with the mesh's first card current and give the caller
    its current card back after: a kernel launch on another card makes that
    card current, and code that names ``cuda`` without an index would
    follow it."""
    @functools.wraps(fn)
    def wrapper(mesh, *args, **kwargs):
        if mesh.first.type != "cuda":
            return fn(mesh, *args, **kwargs)
        with torch.cuda.device(mesh.first):
            return fn(mesh, *args, **kwargs)
    return wrapper


def _shard_masks(mesh, shards, lower, upper, *, single, tile_n, m, rows,
                 backend):
    """Each shard's scan of its own block with the replicated bounds: the
    full-scan kernel (``multi_scan_tiles``, or ``range_scan_tiles`` for one
    query) per shard, in shard order."""
    lo, up = mesh.replicate(lower), mesh.replicate(upper)
    scan = ops._range_scan if single else ops._scan_masks
    return [scan(x, lo[x.device], up[x.device], tile_n=tile_n, m=m, rows=rows,
                 backend=backend) for x in shards]


@_on_first_device
def _distributed_mask(mesh, shards, qlo, qhi, *, tile_n=1024, m=None,
                      rows=None, backend="auto"):
    return tuple(_shard_masks(mesh, shards, qlo, qhi, single=True,
                              tile_n=tile_n, m=m, rows=rows, backend=backend))


distributed_mask = ops.counted(
    "distributed_mask",
    "Sharded single-query match mask: each shard scans its own object block "
    "-> per-shard (n_local,) int8 masks, in shard order.",
)(_distributed_mask)


@_on_first_device
def _distributed_count(mesh, shards, qlo, qhi, *, tile_n=1024, m=None,
                       rows=None, backend="auto"):
    masks = _shard_masks(mesh, shards, qlo, qhi, single=True, tile_n=tile_n,
                         m=m, rows=rows, backend=backend)
    parts = mesh.gather([x.ne(0).sum(dtype=torch.int32) for x in masks])
    return torch.stack(parts).sum(dtype=torch.int32)


distributed_count = ops.counted(
    "distributed_count",
    "Global single-query match count: shard counts summed on the mesh's "
    "first device (the reference's psum).",
)(_distributed_count)


@_on_first_device
def _distributed_multi_mask(mesh, shards, lower, upper, *, tile_n=1024,
                            m=None, rows=None, backend="auto"):
    return tuple(_shard_masks(mesh, shards, lower, upper, single=False,
                              tile_n=tile_n, m=m, rows=rows, backend=backend))


distributed_multi_mask = ops.counted(
    "distributed_multi_mask",
    "Cross-shard fused batch scan: every shard evaluates the whole (m_pad, "
    "Q) query batch against its own object block -> per-shard (Q, n_local) "
    "int8 masks, in shard order.",
)(_distributed_multi_mask)


@_on_first_device
def _distributed_multi_counts(mesh, shards, lower, upper, *, tile_n=1024,
                              m=None, rows=None, backend="auto"):
    masks = _shard_masks(mesh, shards, lower, upper, single=False,
                         tile_n=tile_n, m=m, rows=rows, backend=backend)
    return T.COUNT.distributed_reduce(masks, shards, mesh, tile_n=tile_n,
                                      backend=backend)


distributed_multi_counts = ops.counted(
    "distributed_multi_counts",
    "Cross-shard fused batch count: per-shard (Q,) partial counts summed on "
    "the mesh's first device -> (Q,) int32 global match counts.",
)(_distributed_multi_counts)


@_on_first_device
def _distributed_multi_reduce(mesh, shards, lower, upper, delta_cm=None,
                              base_tomb=None, *, spec, tile_n=1024, m=None,
                              rows=None, backend="auto"):
    masks = _shard_masks(mesh, shards, lower, upper, single=False,
                         tile_n=tile_n, m=m, rows=rows, backend=backend)
    if base_tomb is not None:
        # The tombstone vector shards with the data: the fold is shard-local.
        masks = [_red.fold_tombstones(x, t) for x, t in zip(masks, base_tomb)]
    base = spec.distributed_reduce(masks, shards, mesh, tile_n=tile_n,
                                   backend=backend)
    if delta_cm is None:
        return base
    # The delta block is small and lies on the first device: it is scanned
    # once there, not once per shard, and its payload pairs with the merged
    # base payload.
    return base, ops._delta_payload(delta_cm, lower, upper, spec=spec,
                                    tile_n=tile_n, backend=backend, m=m)


distributed_multi_reduce = ops.counted(
    "distributed_multi_reduce",
    "Cross-shard fused batch scan + the ResultSpec's shard-local reducer and "
    "its merge on the mesh's first device in one op -> the spec payload "
    "(per-shard masks for Ids/Mask; merged counts/top-k/aggregates).",
)(_distributed_multi_reduce)


class DistributedScan:
    """Horizontally partitioned scan over a ``DataMesh`` (build-once facade).

    Single-query (``mask`` / ``query`` / ``count``) and batched
    (``mask_batch`` / ``count_batch`` / ``query_batch`` / ``launch_batch``)
    entry points mirror ``ColumnarScan``: a batch is one counted op and one
    host sync, with the same pow2 query-axis bucketing.
    """

    def __init__(self, dataset: T.Dataset, mesh: Optional[DataMesh] = None,
                 tile_n: int = 1024, *, device=None, backend: str = "auto"):
        self.mesh = mesh if mesh is not None else make_data_mesh(device=device)
        self.tile_n = tile_n
        self.backend = ops.check_backend(backend)
        self.n_devices = self.mesh.size
        padded, self.m, self.n = ops.prepare_columnar(
            dataset.cols, tile_n=tile_n * self.n_devices)
        self.m_pad, self.n_pad = padded.shape
        self.n_local = self.n_pad // self.n_devices
        self.shards = shard_columnar(self.mesh, padded, tile_n=tile_n)

    @property
    def nbytes_index(self) -> int:
        return 0  # a scan needs no auxiliary structures (paper §8)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def _op_kw(self, rows: int) -> dict:
        return dict(tile_n=self.tile_n, m=self.m, rows=rows,
                    backend=self.backend)

    # -- single query ------------------------------------------------------
    def _bounds(self, q: T.RangeQuery):
        return ops.query_bounds_device(q, self.m_pad, self.dtype,
                                       self.mesh.first)

    def mask(self, q: T.RangeQuery) -> np.ndarray:
        qlo, qhi = self._bounds(q)
        out = distributed_mask(self.mesh, self.shards, qlo, qhi,
                               **self._op_kw(q.n_queried_dims))
        return concat_shards(ops.device_get(out))[: self.n] > 0

    def query(self, q: T.RangeQuery) -> np.ndarray:
        return np.nonzero(self.mask(q))[0].astype(np.int64)

    def count(self, q: T.RangeQuery) -> int:
        qlo, qhi = self._bounds(q)
        total = distributed_count(self.mesh, self.shards, qlo, qhi,
                                  **self._op_kw(q.n_queried_dims))
        # +inf padding sentinels never match: nothing to subtract
        return int(ops.device_get(total))

    # -- batched execution (one counted op per batch) ----------------------
    def _batch_bounds(self, batch):
        from repro_torch.core.scan import bucketed_batch_bounds
        if not isinstance(batch, T.QueryBatch):
            batch = T.QueryBatch.from_queries(list(batch))
        _, lo, up = bucketed_batch_bounds(batch, self.m_pad, self.dtype,
                                          self.mesh.first)
        return batch, lo, up, int(batch.dims_mask.any(axis=0).sum())

    def mask_batch(self, batch) -> np.ndarray:
        """(Q, n) bool match masks from one cross-shard fused op."""
        batch, lo, up, rows = self._batch_bounds(batch)
        out = distributed_multi_mask(self.mesh, self.shards, lo, up,
                                     **self._op_kw(rows))
        return concat_shards(ops.device_get(out))[: len(batch), : self.n] > 0

    def count_batch(self, batch) -> list[int]:
        """Per-query global counts: one op, and only (Q,) ints reach the
        host."""
        batch, lo, up, rows = self._batch_bounds(batch)
        counts = distributed_multi_counts(self.mesh, self.shards, lo, up,
                                          **self._op_kw(rows))
        return [int(c) for c in ops.device_get(counts)[: len(batch)]]

    def query_batch(self, batch, spec: T.ResultSpec = T.IDS,
                    delta=None) -> list:
        """Batched execution under any ResultSpec: one counted op (each
        shard's scan and reducer, the merge) and one host sync for the
        payload. ``delta`` folds the mutable plane into the same op: the
        base tombstones shard with the data, the delta block is scanned
        once on the first device."""
        payload, fin = self.launch_batch(batch, spec=spec, delta=delta)
        return fin(ops.device_get(payload))

    def launch_batch(self, batch, spec: T.ResultSpec = T.IDS,
                     delta=None) -> tuple:
        """Device half of ``query_batch`` -> (payload, finalize): the op
        without its host sync; ``finalize(host_payload)`` takes the
        caller's one counted ``ops.device_get(payload)``."""
        spec = T.validate_mode(spec).validate(self.m)
        batch, lo, up, rows = self._batch_bounds(batch)
        dcm = tomb = None
        if delta is not None and not delta.is_empty:
            dcm = delta.device_cm(self.tile_n, self.mesh.first)
            if delta.has_base_tombs:
                tomb = tuple(
                    delta.base_tomb_dev(self.n_pad, dev,
                                        shard=(s, self.n_local))
                    for s, dev in enumerate(self.mesh.devices))
        payload = distributed_multi_reduce(self.mesh, self.shards, lo, up,
                                           dcm, tomb, spec=spec,
                                           **self._op_kw(rows))
        n_q, n = len(batch), self.n

        def finalize(host_payload):
            if spec.sharded_payload:
                host_payload = concat_shards(host_payload)
            return spec.finalize(host_payload, n_q, n)
        if dcm is None:
            return payload, finalize
        return payload, delta.merge_finalizer(spec, finalize, n_q)

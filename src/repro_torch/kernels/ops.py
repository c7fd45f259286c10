"""Counted public ops around the MDRQ kernels.

Ports ``repro/kernels/ops.py``: the layout/padding policy (pad m to
``SUBLANES`` with match-all bounds, n to the tile size with +inf objects that
never match), the dtype of the bounds, and one launch counter per op.

Backend: every op takes ``backend``. Under ``"auto"`` (the default) the
kernel wrappers follow the tensor's device — the hand-written CUDA kernels
for a CUDA tensor, the plain PyTorch versions (``ref.py``) for a CPU tensor.
``"torch"`` runs the plain versions on any device; it exists so a caller can
hold the kernels against them on the card. Nothing falls back silently: a
kernel that fails to build or launch raises.

Instrumentation: every public op is built by ``counted`` — a wrapper that
bumps a named launch counter in the metrics registry (family
``mdrq_launches_total{op=...}``) before delegating — and ``device_get`` is
the counted device->host transfer point. Tests use the counters to assert
launch/sync budgets (one fused launch and one host sync per bucket) that
wall-clock measurements cannot see. ``kernel_launches()`` separately reports
how often each CUDA kernel was actually launched. The counts stay exact when
two threads bump them (the pipelined server launches on its admission thread
and syncs on its finalizer thread): every bump takes one lock.

Warm keys: the port compiles nothing per shape, so the counterpart of the
reference's AOT cache is a record. Each counted call also notes its key —
(op, each tensor argument's shape, dtype and device type, every other
argument's value) — in the warm set; a key's first appearance is appended to
``trace_log()``, the counterpart of the reference's retrace log. A cold key
pays what a first use costs here (the ``_build`` load of the extensions, the
caching allocator's first allocations of its shapes); a warm key has run
once. ``serve.pipeline`` warms its hot path's keys at construction and
asserts that steady traffic of the advertised shapes adds none. The
scans' ``rows`` argument is left out of the key: it only picks one of the
register instances compiled into the same library, so a new value costs
nothing cold.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import kv_visit as _kvv
from repro_torch.kernels import multi_scan as _ms
from repro_torch.kernels import range_scan as _rs
from repro_torch.kernels import reducers as _red
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import va_filter as _va
from repro_torch.obs import metrics as _obs_metrics

BACKENDS = ("auto", "torch")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    return backend


# -- launch / transfer instrumentation ---------------------------------------
_LAUNCH_FAMILY = "mdrq_launches_total"
_LAUNCH_HELP = ("Kernel launches (and device->host transfers, op=host_sync) "
                "counted per public op wrapper call")
# op name -> its registry Counter. Cached so the per-launch cost is one dict
# lookup + one float add; registry reset() keeps these objects live.
_COUNTERS: dict[str, _obs_metrics.Counter] = {}
# Guards the counters and the warm set: a registry ``Counter.inc`` is a
# read-modify-write, and the two serving threads both bump ``host_sync``.
_LOCK = threading.Lock()
_WARM: set = set()          # every warm key run since ``clear_warm_keys``
_TRACE_LOG: list = []       # first appearances since ``reset_trace_log``


def _bump(name: str, key=None) -> None:
    """Count one launch of op ``name`` (or one ``host_sync``); note its warm
    ``key`` (counted ops pass one)."""
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _obs_metrics.registry().counter(_LAUNCH_FAMILY,
                                                help=_LAUNCH_HELP, op=name)
            _COUNTERS[name] = c
        c.inc()
        if key is not None and key not in _WARM:
            _WARM.add(key)
            _TRACE_LOG.append(key)


def counter(name: str) -> int:
    """Launches of op ``name`` (or ``"host_sync"`` transfers) since reset."""
    c = _COUNTERS.get(name)
    return int(c.value) if c is not None else 0


def counters() -> dict[str, int]:
    """Nonzero per-op launch counts since the last reset."""
    return {name: int(c.value) for name, c in _COUNTERS.items() if c.value}


def reset_counters() -> None:
    for c in _COUNTERS.values():
        c.reset()


def kernel_launches() -> dict[str, int]:
    """CUDA kernel launches per kernel wrapper since the last reset (plain
    versions never count)."""
    return dict(_build.LAUNCHES)


def reset_kernel_launches() -> None:
    _build.reset_launches()


def device_get(x):
    """Counted device->host transfer — the host-sync tax the cost model prices.

    Accepts a single tensor or a payload tuple/list, nested (the ResultSpec
    reducers return e.g. ``(values, indices, counts)``, and under a delta the
    pair ``(base_payload, delta_payload)``); either way it is one logical
    synchronization, counted once. Returns numpy arrays in the same nesting.
    """
    _bump("host_sync")
    return _to_host(x)


def _to_host(x):
    if isinstance(x, (tuple, list)):
        return tuple(_to_host(t) for t in x)
    return x.cpu().numpy()


# -- warm keys ------------------------------------------------------------------
# Arguments that select among code already loaded, so no part of the key.
_UNKEYED = frozenset({"rows"})


def _abstract(x):
    """Hashable key atom for one argument: a tensor collapses to (shape,
    dtype, device type), a sequence to its atoms; anything else (sizes,
    result specs, backends) stays."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, (tuple, list)):
        return ("seq", tuple(_abstract(e) for e in x))
    return x


def warm_key(name: str, args: tuple, kwargs: dict) -> tuple:
    """The warm-set key of one call of op ``name``."""
    return (name, tuple(_abstract(a) for a in args),
            tuple(sorted((k, _abstract(v)) for k, v in kwargs.items()
                         if k not in _UNKEYED)))


def trace_log() -> tuple:
    """Keys run for the first time since the last ``reset_trace_log``, in
    order — empty when every call since found its key warm."""
    with _LOCK:
        return tuple(_TRACE_LOG)


def reset_trace_log() -> None:
    with _LOCK:
        _TRACE_LOG.clear()


def warm_keys() -> tuple:
    """Every key run since the last ``clear_warm_keys``."""
    with _LOCK:
        return tuple(_WARM)


def clear_warm_keys() -> None:
    with _LOCK:
        _WARM.clear()


def counted(name: str, doc: str):
    """Build a public op: bump the named launch counter and note the call's
    warm key, then delegate. One definition keeps every op in the
    accounting."""
    def deco(fn):
        def wrapper(*args, **kwargs):
            _bump(name, warm_key(name, args, kwargs))
            return fn(*args, **kwargs)
        wrapper.__name__ = wrapper.__qualname__ = name
        wrapper.__doc__ = doc
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


# -- layout and bounds ---------------------------------------------------------

def prepare_columnar(
    cols: np.ndarray, tile_n: int = _rs.DEFAULT_TILE_N
) -> tuple[np.ndarray, int, int]:
    """Pad (m, n) columnar data for the kernels.

    Dim padding rows are 0.0 (queried with match-all bounds); object padding
    columns are +inf (never match any finite upper bound).

    Returns (padded C-contiguous float32 array, m, n) with the original
    sizes. (A column-permuted input, as the tree builds pass, can come in
    column-major; the kernels take row-major rows.)
    """
    from repro_torch.core import types as T  # deferred: breaks ops<->core cycle
    m, n = cols.shape
    x = T.pad_axis(cols, 0, _rs.SUBLANES, 0.0)
    x = T.pad_axis(x, 1, tile_n, np.inf)
    return np.ascontiguousarray(x, dtype=np.float32), m, n


def upload(a, device) -> torch.Tensor:
    """Host array -> tensor on ``device``: the one per-batch host->device
    copy of the serving paths.

    On a CUDA target the bytes are staged in pinned host memory
    (``pin_memory()``) and copied with ``non_blocking=True``: the copy
    queues on the current stream and the call returns at once, where a
    pageable copy would wait for everything already on the stream — an
    uncounted host sync. PyTorch's caching host allocator keeps the pinned
    block until the copy has run. On a CPU target it is ``torch.as_tensor``.
    The choice follows ``device``, never whether a card is present.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.as_tensor(a, device=dev)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # torch.from_numpy warns on read-only arrays
        a = a.copy()
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


def query_bounds_device(q, m_pad: int, dtype: torch.dtype,
                        device) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_pad, 1) finite device bounds for a query (pad rows = match-all).

    ``dtype`` threads into the match-all substitution so the extrema stay
    finite *in the comparison dtype*.
    """
    from repro_torch.core import types as T
    lo, up = T.padded_query_bounds(q, m_pad)
    lo, up = T.finite_query_bounds(lo, up, dtype=dtype)
    return (upload(lo.reshape(-1, 1), device).to(dtype),
            upload(up.reshape(-1, 1), device).to(dtype))


def batch_bounds_device(batch, m_pad: int, dtype: torch.dtype, device,
                        q_pad: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_pad, q_pad or Q) finite device bounds for a QueryBatch.

    Pad rows — and padding query columns beyond Q when ``q_pad`` rounds the
    batch to a bucket — are match-all in ``dtype``'s finite extrema; callers
    drop their output rows.
    """
    from repro_torch.core import types as T
    if not isinstance(batch, T.QueryBatch):
        batch = T.QueryBatch.from_queries(list(batch))
    lo, up = batch.bounds_columnar(m_pad, q_pad, dtype=dtype)
    return (upload(lo, device).to(dtype), upload(up, device).to(dtype))


def dim_ids_device(dim_ids: np.ndarray, m_pad: int, device) -> torch.Tensor:
    """Constrained-dim ids as a device int32 tensor, range-checked on the
    host (the vertical kernel clamps rather than reads out of bounds)."""
    ids = np.asarray(dim_ids, np.int32)
    if ids.size and (ids.min() < 0 or ids.max() >= m_pad):
        raise ValueError(f"dim ids out of range [0, {m_pad})")
    return upload(ids, device)


# -- the mask kernels, per backend --------------------------------------------

def _scan_masks(data_cm, lower, upper, *, tile_n=_rs.DEFAULT_TILE_N,
                m=None, rows=None, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.multi_scan_ref(data_cm, lower, upper)
    return _ms.multi_scan_tiles(data_cm, lower, upper, tile_n=tile_n, m=m,
                                rows=rows)


def _vertical_masks(data_cm, dim_ids, lower, upper, *,
                    tile_n=_rs.DEFAULT_TILE_N, rows=None, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.multi_scan_vertical_ref(data_cm, dim_ids, lower, upper)
    return _ms.multi_scan_vertical(data_cm, dim_ids, lower, upper,
                                   tile_n=tile_n, rows=rows)


def _range_scan(data_cm, lower, upper, *, tile_n=_rs.DEFAULT_TILE_N,
                m=None, rows=None, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.range_scan_ref(data_cm, lower, upper)
    return _rs.range_scan_tiles(data_cm, lower, upper, tile_n=tile_n, m=m,
                                rows=rows)


range_scan = counted(
    "range_scan",
    "Full vectorized range scan over padded columnar data -> (n_pad,) int8.",
)(_range_scan)


def _range_scan_vertical(data_cm, dim_ids, lower, upper, *,
                         tile_n=_rs.DEFAULT_TILE_N, backend="auto"):
    if check_backend(backend) == "torch":
        d = dim_ids.long()
        return _ref.range_scan_ref(data_cm[d], lower[d, 0], upper[d, 0])
    return _rs.range_scan_vertical(data_cm, dim_ids, lower, upper,
                                   tile_n=tile_n)


range_scan_vertical = counted(
    "range_scan_vertical",
    "Partial-match scan touching only queried dims -> (n_pad,) int8.",
)(_range_scan_vertical)


multi_range_scan = counted(
    "multi_range_scan",
    "Fused full scan of a query batch -> (Q, n_pad) int8 masks.",
)(_scan_masks)

multi_range_scan_vertical = counted(
    "multi_range_scan_vertical",
    "Batched partial-match scan -> (Q, n_pad) int8 masks.",
)(_vertical_masks)


def _range_scan_rows(data_rm, lower, upper, *, tile_rows=512, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.range_scan_rows_ref(data_rm, lower, upper)
    return _rs.range_scan_rows(data_rm, lower, upper, tile_rows=tile_rows)


range_scan_rows = counted(
    "range_scan_rows",
    "Row-major (horizontal layout) scan -> (n_pad,) int8.",
)(_range_scan_rows)


def _visit_masks(data_cm, query_ids, block_ids, lower, upper, *,
                 tile_n=_rs.DEFAULT_TILE_N, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.multi_scan_blocks_ref(_rs.blocks_view(data_cm, tile_n),
                                          query_ids, block_ids, lower, upper)
    return _ms.multi_scan_visit(data_cm, query_ids, block_ids, lower, upper,
                                tile_n=tile_n)


multi_range_scan_visit = counted(
    "multi_range_scan_visit",
    "Batched two-phase refinement over a (query, block) visit list "
    "-> (V, tile_n) int8 per-visit masks.",
)(_visit_masks)


def _range_scan_visit(data_cm, block_ids, lower, upper, *,
                      tile_n=_rs.DEFAULT_TILE_N, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.multi_scan_blocks_ref(_rs.blocks_view(data_cm, tile_n),
                                          torch.zeros_like(block_ids),
                                          block_ids, lower, upper)
    return _rs.range_scan_visit(data_cm, block_ids, lower, upper,
                                tile_n=tile_n)


range_scan_visit = counted(
    "range_scan_visit",
    "Scan only the listed tile ids -> (n_visit, tile_n) int8 masks.",
)(_range_scan_visit)


def _va_filter(packed, cell_lo, cell_hi, m, *, backend="auto"):
    if check_backend(backend) == "torch":
        return _ref.va_filter_packed_ref(packed, cell_lo[:, 0], cell_hi[:, 0],
                                         m)
    return _va.va_filter_packed(packed, cell_lo, cell_hi, m)


va_filter = counted(
    "va_filter",
    "Packed VA-file approximation filter -> (n_pad,) int8 candidate mask.",
)(_va_filter)


def _multi_va_filter(packed, cell_lo, cell_hi, m, *, block_n, backend="auto"):
    if check_backend(backend) == "torch":
        out = _ref.multi_va_filter_packed_ref(packed, cell_lo, cell_hi, m)
    else:
        out = _va.multi_va_filter_packed(packed, cell_lo, cell_hi, m)
    q_n, n_pad = out.shape
    if n_pad % block_n:
        raise ValueError(f"n_pad={n_pad} is not a multiple of "
                         f"block_n={block_n}")
    # Reduce to per-(query, block) survivor bits on the device: only the
    # small (Q, n_blocks) array ever crosses to the host.
    return out.ne(0).reshape(q_n, n_pad // block_n, block_n).any(dim=2)


multi_va_filter = counted(
    "multi_va_filter",
    "Batched packed VA filter, one launch per query batch: the (Q, n_pad) "
    "candidate masks reduced on the device, in the same op, to "
    "(Q, n_pad // block_n) bool per-block survivor bits (the phase-2 visit "
    "list seed).",
)(_multi_va_filter)


# -- fused spec-reduce launches (the ResultSpec layer's device half) ----------
# Each op composes a mask kernel with the spec's on-device reducer in ONE
# counted op, so a reduced result shape — count, top-k, aggregate — is one
# fused launch and, with the single ``device_get`` of the payload, one host
# sync per batch. The identity specs (Ids/Mask) flow through unchanged: their
# "payload" is the mask itself.
#
# The mutable data plane: each op takes two optional extras in the same
# counted op, so a live delta costs no further counted launch —
#   * ``base_tomb`` — (n_pad,) int8 tombstone flags in the data's storage
#     order, folded into the base masks before the spec's reducer;
#   * ``delta_cm``  — the delta rows as a (m_pad, d_pad) columnar block (the
#     base data's padding contract; tombstoned delta rows are +inf). The op
#     scans it with the batch's bounds through the same mask kernel and
#     reducers as the base and returns the pair (base_payload,
#     delta_payload); one ``device_get`` of the pair is still one host sync,
#     and the spec's ``merge_delta`` folds the halves on the host.

def _delta_payload(delta_cm, lower, upper, *, spec, tile_n, backend, m=None):
    """Scan + reduce the delta block with the batch's bounds."""
    dmask = _scan_masks(delta_cm, lower, upper, tile_n=tile_n, m=m,
                        backend=backend)
    return spec.device_reduce(dmask, delta_cm, tile_n=tile_n, backend=backend)


def _reduce_with_delta(mask, data_cm, lower, upper, delta_cm, base_tomb, *,
                       spec, tile_n, backend, m=None):
    """Fold the base tombstones, reduce the base, and pair it with the
    delta's payload when there is a delta block."""
    if base_tomb is not None:
        mask = _red.fold_tombstones(mask, base_tomb)
    base = spec.device_reduce(mask, data_cm, tile_n=tile_n, backend=backend)
    if delta_cm is None:
        return base
    return base, _delta_payload(delta_cm, lower, upper, spec=spec,
                                tile_n=tile_n, backend=backend, m=m)


def _multi_scan_reduce(data_cm, lower, upper, delta_cm=None, base_tomb=None, *,
                       spec, tile_n=_rs.DEFAULT_TILE_N, m=None, rows=None,
                       backend="auto"):
    mask = _scan_masks(data_cm, lower, upper, tile_n=tile_n, m=m, rows=rows,
                       backend=backend)
    return _reduce_with_delta(mask, data_cm, lower, upper, delta_cm, base_tomb,
                              spec=spec, tile_n=tile_n, backend=backend, m=m)


multi_scan_reduce = counted(
    "multi_scan_reduce",
    "Fused full scan of a query batch + the ResultSpec's on-device reducer "
    "in one launch -> the spec's payload (masks for Ids/Mask, (Q,) counts, "
    "(Q, k) top-k values/positions, (Q,) aggregates).",
)(_multi_scan_reduce)


def _multi_scan_vertical_reduce(data_cm, dim_ids, lower, upper, delta_cm=None,
                                base_tomb=None, *, spec,
                                tile_n=_rs.DEFAULT_TILE_N, m=None, rows=None,
                                backend="auto"):
    mask = _vertical_masks(data_cm, dim_ids, lower, upper, tile_n=tile_n,
                           rows=rows, backend=backend)
    # The delta is small: a full scan of it is exact (unconstrained dims
    # carry match-all bounds), so it needs no vertical variant.
    return _reduce_with_delta(mask, data_cm, lower, upper, delta_cm, base_tomb,
                              spec=spec, tile_n=tile_n, backend=backend, m=m)


multi_scan_vertical_reduce = counted(
    "multi_scan_vertical_reduce",
    "Batched partial-match scan + ResultSpec reducer in one launch.",
)(_multi_scan_vertical_reduce)


def _multi_visit_reduce(data_cm, query_ids, block_ids, valid, visit_index,
                        lower, upper, delta_cm=None, base_tomb=None, *, spec,
                        tile_n=_rs.DEFAULT_TILE_N, n_queries=1, m=None,
                        backend="auto"):
    masks = _visit_masks(data_cm, query_ids, block_ids, lower, upper,
                         tile_n=tile_n, backend=backend)
    if base_tomb is not None:
        masks = _red.fold_tombstones(
            masks, _red.gather_tomb_blocks(base_tomb, block_ids, tile_n))
    base = spec.reduce_visits(masks, data_cm, query_ids, block_ids, valid,
                              visit_index, tile_n=tile_n, n_queries=n_queries,
                              backend=backend)
    if delta_cm is None:
        return base
    # The (m_pad, q_pad) bounds cover the whole batch, so the delta scans
    # once for every query whatever blocks it visited (``m``: its real dims).
    return base, _delta_payload(delta_cm, lower, upper, spec=spec,
                                tile_n=tile_n, backend=backend, m=m)


multi_visit_reduce = counted(
    "multi_visit_reduce",
    "Batched two-phase refinement over a (query, block) visit list + the "
    "ResultSpec's on-device visit reducer in one launch (shared by the tree "
    "indexes and the VA-file phase 2).",
)(_multi_visit_reduce)


def _mask_counts(mask: torch.Tensor) -> torch.Tensor:
    return mask.ne(0).sum(dim=-1, dtype=torch.int32)


mask_counts = counted(
    "mask_counts",
    "On-device match counts over the object axis (count-only result mode). "
    "Works for both (n_pad,) single-query and (Q, n_pad) batched masks; "
    "padding objects are +inf sentinels that never match, so summing the "
    "padded axis is exact.",
)(_mask_counts)


def _kv_visit_attention(q, k_blocks, v_blocks, block_ids, pos, k_scale=None,
                        v_scale=None, *, backend="auto"):
    if check_backend(backend) == "torch":
        _kvv.check_inputs(q, k_blocks, v_blocks, block_ids, pos, k_scale,
                          v_scale)
        return _ref.kv_visit_attention_ref(q, k_blocks, v_blocks, block_ids,
                                           pos, k_scale, v_scale)
    return _kvv.kv_visit_attention(q, k_blocks, v_blocks, block_ids, pos,
                                   k_scale, v_scale)


kv_visit_attention = counted(
    "kv_visit_attention",
    "Block-visit decode attention (zone-map-pruned KV; an int8 cache with "
    "its per-token scales) -> (B, KV, G, hd).",
)(_kv_visit_attention)

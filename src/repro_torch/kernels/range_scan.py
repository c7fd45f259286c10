"""Single-query range scans, and the launch plumbing every scan shares.

Ports ``repro/kernels/range_scan.py`` (``range_scan_tiles``,
``range_scan_vertical``, ``range_scan_rows``, ``range_scan_visit``). On the
card the columnar two are the Q=1 launch of the batched kernel template
``scan_kernel`` in ``csrc/scan.cu`` (full and vertical instances); the visit
scan launches ``multi_scan_visit_kernel`` in ``csrc/visit.cu`` (the
batched visit form is the block-major ``multi_scan_visit_sorted_kernel``
there, scheduled by ``visit_schedule``); the row-major scan has its own,
``range_scan_rows_kernel`` in ``csrc/rows.cu``. On a CPU tensor each runs its
plain version.

Layout and padding contract (``ops.prepare_columnar``): data is
dimension-major ``(m_pad, n_pad)``; m pads to a multiple of ``SUBLANES`` with
rows of 0.0 that carry match-all bounds, n pads to a multiple of ``tile_n``
with ``+inf`` objects that never match a finite upper bound. Bounds are finite
and cast to the data dtype before comparing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# The padding contract the reference's TPU layout fixed; the port keeps it so
# both packages pad a dataset to the same array.
LANES = 128
SUBLANES = 8
DEFAULT_TILE_N = 1024

VEC = 4  # objects per CUDA thread (csrc/common.cuh)
# Sorted visits one thread block of the block-major visit kernel takes
# (csrc/visit.cu; the launcher halves it only when shared memory is short).
VISITS_PER_BLOCK = 64
# The columnar scan kernel (csrc/scan.cu) holds 2 * n_pairs rows of its
# objects in registers, n_pairs one of SCAN_PAIRS (its instances), and
# stages the bounds of up to qg queries in SCAN_SMEM_BYTES of shared memory.
SCAN_PAIRS = (2, 4, 6, 8, 10, 12)
SCAN_SMEM_BYTES = 46 * 1024


def check_tiling(m_pad: int, n_pad: int, tile_n: int) -> None:
    """Raise unless the padded shape satisfies the padding contract."""
    if m_pad % SUBLANES:
        raise ValueError(f"m_pad={m_pad} is not a multiple of {SUBLANES}")
    if tile_n % LANES or n_pad % tile_n:
        raise ValueError(f"n_pad={n_pad} / tile_n={tile_n}: need "
                         f"n_pad % tile_n == 0 and tile_n % {LANES} == 0")


def block_threads(n_pad: int) -> int:
    """Threads per block: the largest of 256..32 whose tile of
    ``4 * threads`` objects divides ``n_pad`` (always found for
    ``n_pad % 128 == 0``)."""
    for t in (256, 128, 64, 32):
        if n_pad % (VEC * t) == 0:
            return t
    raise ValueError(f"n_pad={n_pad} is not a multiple of {VEC * 32}")


def cuda_input(x: torch.Tensor, dtype: torch.dtype, name: str,
               device: torch.device) -> torch.Tensor:
    """Check a kernel input on the card: device, dtype, contiguity and the
    16-byte alignment of the vector loads."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, the kernel takes {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return x


def bounds_input(b: torch.Tensor, name: str, data: torch.Tensor) -> torch.Tensor:
    """Bounds cast to the data dtype (the comparison dtype), contiguous."""
    if b.device != data.device:
        raise ValueError(f"{name} is on {b.device}, data on {data.device}")
    return b.to(data.dtype).contiguous()


def compared_rows(m: int | None, m_pad: int) -> int:
    """The rows a full scan compares: ``m`` (the real dims; the rows below
    ``m_pad`` beyond it are padding, 0.0 under match-all bounds) or, by
    default, all ``m_pad``."""
    if m is None:
        return m_pad
    if not 1 <= m <= m_pad:
        raise ValueError(f"m={m} is not in [1, m_pad={m_pad}]")
    return m


def scan_launch_shape(q_n: int, m_rows: int, rows_bound: int
                      ) -> tuple[int, int]:
    """(n_pairs, qg) of one ``scan_kernel`` launch, from shapes alone.

    ``rows_bound`` bounds the rows any query of the launch can constrain
    (``m_rows`` for the full scan, ``min(m_pad, Q * D_max)`` for the
    vertical one): the kernel holds the smallest instance's 2 * n_pairs of
    them in registers, at most 24 per pass. ``qg`` queries' bounds, row
    bits and the per-row lists fit in ``SCAN_SMEM_BYTES`` (the layout of
    ``Layout`` in ``csrc/scan.cu``)."""
    need = -(-min(rows_bound, 2 * SCAN_PAIRS[-1]) // 2)
    n_pairs = next(p for p in SCAN_PAIRS if p >= need)
    words = -(-m_rows // 32)
    per_query = 16 * n_pairs + 16 + 4 * words
    qg = min(q_n, (SCAN_SMEM_BYTES - 12 * m_rows) // per_query)
    if qg < 1:
        raise ValueError(f"{m_rows} rows leave no room for a query's bounds")
    return n_pairs, qg


def scan_cuda(name: str, data_cm: torch.Tensor, lower: torch.Tensor,
              upper: torch.Tensor, m: int | None = None,
              rows: int | None = None) -> torch.Tensor:
    """Launch the full-scan ``scan_kernel`` over rows [0, m) -> (Q, n_pad)
    int8; counted as ``name``. ``rows``, where given, bounds the rows whose
    bounds some query sets."""
    dev = data_cm.device
    data = cuda_input(data_cm, torch.float32, "data_cm", dev)
    m_pad, n_pad = data.shape
    m_rows = compared_rows(m, m_pad)
    q_n = lower.shape[1]
    lo = bounds_input(lower, "lower", data)
    up = bounds_input(upper, "upper", data)
    out = torch.empty((q_n, n_pad), dtype=torch.int8, device=dev)
    bound = m_rows if rows is None else min(m_rows, rows)
    n_pairs, qg = scan_launch_shape(q_n, m_rows, max(bound, 1))
    _build.launch(name, "mdrq_scan", dev, data, n_pad, m_pad, m_rows, None, 0,
                  lo, up, q_n, n_pairs, qg, out)
    return out


def vertical_cuda(name: str, data_cm: torch.Tensor, dim_ids: torch.Tensor,
                  lower: torch.Tensor, upper: torch.Tensor,
                  rows: int | None = None) -> torch.Tensor:
    """Launch the vertical ``scan_kernel`` -> (Q, n_pad) int8; counted as
    ``name``. ``dim_ids`` is (Q, D_max) with every id in [0, m_pad);
    ``rows``, where given, bounds the distinct ids it lists."""
    dev = data_cm.device
    data = cuda_input(data_cm, torch.float32, "data_cm", dev)
    m_pad, n_pad = data.shape
    q_n, d_max = dim_ids.shape
    if d_max < 1:
        raise ValueError("dim_ids lists no dimension")
    if dim_ids.device != dev:
        raise ValueError(f"dim_ids is on {dim_ids.device}, data on {dev}")
    ids = dim_ids.to(torch.int32).contiguous()
    lo = bounds_input(lower, "lower", data)
    up = bounds_input(upper, "upper", data)
    out = torch.empty((q_n, n_pad), dtype=torch.int8, device=dev)
    bound = min(m_pad, q_n * d_max, m_pad if rows is None else rows)
    n_pairs, qg = scan_launch_shape(q_n, m_pad, max(bound, 1))
    _build.launch(name, "mdrq_scan", dev, data, n_pad, m_pad, m_pad, ids,
                  d_max, lo, up, q_n, n_pairs, qg, out)
    return out


def range_scan_tiles(
    data_cm: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
    m: int | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """Full columnar range scan of one query.

    Args:
      data_cm: (m_pad, n_pad) columnar data; m_pad % 8 == 0, n_pad % tile_n == 0.
      lower, upper: (m_pad, 1) finite bounds.
      m: compare rows [0, m) only (the real dims; the default compares all
        m_pad rows, which gives the same mask under the padding contract).
      rows: how many dims the query constrains, where the caller knows it
        (sizes the kernel's registers; any value gives the same mask).

    Returns:
      (n_pad,) int8 match mask.
    """
    m_pad, n_pad = data_cm.shape
    check_tiling(m_pad, n_pad, tile_n)
    if lower.shape != (m_pad, 1) or upper.shape != (m_pad, 1):
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"!= ({m_pad}, 1)")
    if not data_cm.is_cuda:
        r = compared_rows(m, m_pad)
        return _ref.range_scan_ref(data_cm[:r], lower[:r], upper[:r])
    return scan_cuda("range_scan_tiles", data_cm, lower, upper, m, rows)[0]


def range_scan_vertical(
    data_cm: torch.Tensor,
    dim_ids: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """Partial-match scan of one query touching only the listed dimensions.

    Args:
      data_cm: (m_pad, n_pad) columnar data.
      dim_ids: (n_qdims,) int32 ids of the queried dimensions (n_qdims >= 1).
      lower, upper: (m_pad, 1) finite bounds (indexed by dim_ids).

    Returns:
      (n_pad,) int8 match mask over the queried dimensions only.
    """
    m_pad, n_pad = data_cm.shape
    check_tiling(m_pad, n_pad, tile_n)
    if dim_ids.ndim != 1 or dim_ids.shape[0] < 1:
        raise ValueError(f"dim_ids must be (n_qdims >= 1,), got "
                         f"{tuple(dim_ids.shape)}")
    if lower.shape != (m_pad, 1) or upper.shape != (m_pad, 1):
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"!= ({m_pad}, 1)")
    if not data_cm.is_cuda:
        d = dim_ids.long()
        return _ref.range_scan_ref(data_cm[d], lower[d, 0], upper[d, 0])
    return vertical_cuda("range_scan_vertical", data_cm, dim_ids[None, :],
                         lower, upper)[0]


def range_scan_rows(
    data_rm: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_rows: int = 512,
) -> torch.Tensor:
    """Row-major scan of one query (the paper's horizontal layout).

    Args:
      data_rm: (n_pad, m_pad) row-major data, n_pad % tile_rows == 0,
        m_pad % 8 == 0 (padding rows +inf, padding dims 0.0).
      lower, upper: (1, m_pad) finite bounds.

    Returns:
      (n_pad,) int8 match mask.
    """
    n_pad, m_pad = data_rm.shape
    if n_pad % tile_rows or m_pad % SUBLANES:
        raise ValueError(f"data_rm ({n_pad}, {m_pad}) / tile_rows={tile_rows}: "
                         f"need n_pad % tile_rows == 0 and m_pad % {SUBLANES} "
                         f"== 0")
    if lower.shape != (1, m_pad) or upper.shape != (1, m_pad):
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"!= (1, {m_pad})")
    if not data_rm.is_cuda:
        return _ref.range_scan_rows_ref(data_rm, lower, upper)
    dev = data_rm.device
    data = cuda_input(data_rm, torch.float32, "data_rm", dev)
    lo = bounds_input(lower, "lower", data)
    up = bounds_input(upper, "upper", data)
    out = torch.empty((n_pad,), dtype=torch.int8, device=dev)
    _build.launch("range_scan_rows", "mdrq_range_scan_rows", dev, data, n_pad,
                  m_pad, lo, up, out)
    return out


def check_visits(data_cm: torch.Tensor, block_ids: torch.Tensor,
                 tile_n: int) -> int:
    """Raise unless the data's tiling and the (V,) block ids fit the visit
    kernel; returns m_pad."""
    m_pad, n_pad = data_cm.shape
    check_tiling(m_pad, n_pad, tile_n)
    if block_ids.ndim != 1:
        raise ValueError(f"block_ids must be (V,), got {tuple(block_ids.shape)}")
    return m_pad


def blocks_view(data_cm: torch.Tensor, tile_n: int) -> torch.Tensor:
    """(m_pad, n_pad) columnar data as an (n_blocks, m_pad, tile_n) view."""
    m_pad, n_pad = data_cm.shape
    return data_cm.reshape(m_pad, n_pad // tile_n, tile_n).permute(1, 0, 2)


def visit_schedule(query_ids: torch.Tensor, block_ids: torch.Tensor,
                   n_blocks: int, q_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-major order of a (query, block) visit list -> (keys, order).

    ``keys`` (int64) is ascending: each visit's clamped block id (negative
    ids -> 0) times ``q_n`` plus its clamped query id; ``order[i]`` (int64)
    is the list row of the i-th sorted visit. The sort runs on the visits'
    device with no host read: the block-major visit kernel cuts the sorted
    list into ranges of ``VISITS_PER_BLOCK`` visits, one per thread block,
    and writes the mask of sorted visit i to row ``order[i]``. The sort need
    not be stable: equal keys give equal rows.
    """
    b = block_ids.long().clamp(0, n_blocks - 1)
    q = query_ids.long().clamp(0, q_n - 1)
    return torch.sort(b * q_n + q)


def visit_cuda(name: str, data_cm: torch.Tensor, query_ids, block_ids: torch.Tensor,
               lower: torch.Tensor, upper: torch.Tensor,
               tile_n: int) -> torch.Tensor:
    """Launch a visit kernel -> (V, tile_n) int8; counted as ``name``.

    With ``query_ids`` the list is sorted block-major (``visit_schedule``)
    and ``multi_scan_visit_sorted_kernel`` reads each visited block once per
    run of its visitors; ``query_ids=None`` (one query, bounds column 0)
    launches ``multi_scan_visit_kernel``, one thread block per visit."""
    dev = data_cm.device
    data = cuda_input(data_cm, torch.float32, "data_cm", dev)
    m_pad, n_pad = data.shape
    check_tiling(m_pad, n_pad, tile_n)
    n_visit = block_ids.shape[0]
    for x, label in ((query_ids, "query_ids"), (block_ids, "block_ids")):
        if x is not None and x.device != dev:
            raise ValueError(f"{label} is on {x.device}, data on {dev}")
    lo = bounds_input(lower, "lower", data)
    up = bounds_input(upper, "upper", data)
    q_n = lo.shape[1]
    out = torch.empty((n_visit, tile_n), dtype=torch.int8, device=dev)
    if not n_visit:
        return out
    if query_ids is None:
        bids = block_ids.to(torch.int32).contiguous()
        _build.launch(name, "mdrq_multi_scan_visit", dev, data, n_pad, m_pad,
                      bids, n_visit, lo, up, q_n, tile_n, out)
        return out
    keys, order = visit_schedule(query_ids, block_ids, n_pad // tile_n, q_n)
    _build.launch(name, "mdrq_multi_scan_visit_sorted", dev, data, n_pad,
                  m_pad, keys, order, n_visit, lo, up, q_n, tile_n, out)
    return out


def range_scan_visit(
    data_cm: torch.Tensor,
    block_ids: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """Two-phase scan of one query: visit only the listed (m_pad, tile_n)
    blocks.

    Args:
      data_cm: (m_pad, n_pad) columnar data, n_pad % tile_n == 0.
      block_ids: (n_visit,) int32 tile indices into [0, n_pad / tile_n);
        padding entries are negative (clamped to 0; callers drop their rows).
      lower, upper: (m_pad, 1) finite bounds.

    Returns:
      (n_visit, tile_n) int8 per-visit masks.
    """
    m_pad = check_visits(data_cm, block_ids, tile_n)
    if lower.shape != (m_pad, 1) or upper.shape != (m_pad, 1):
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"!= ({m_pad}, 1)")
    if not data_cm.is_cuda:
        zeros = torch.zeros_like(block_ids)
        return _ref.multi_scan_blocks_ref(blocks_view(data_cm, tile_n), zeros,
                                          block_ids, lower, upper)
    return visit_cuda("range_scan_visit", data_cm, None, block_ids, lower,
                      upper, tile_n)

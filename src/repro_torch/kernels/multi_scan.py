"""Fused multi-query (batched) columnar range scans.

Ports ``repro/kernels/multi_scan.py`` (``multi_scan_tiles``,
``multi_scan_vertical``, ``multi_scan_visit``): a (Q, m) batch of query boxes
against the (m, n) columnar dataset in one launch, each data tile read from
device memory once per batch, not once per query; the visit form scans only
the (query, block) pairs a two-phase index lists. On a CUDA tensor each
wrapper launches its kernel in ``csrc/scan.cu`` or ``csrc/visit.cu`` (see the
design notes there); on a CPU tensor it runs the plain version in ``ref.py``.

Query bounds are laid out **query-minor**: ``lower``/``upper`` are
``(m_pad, Q)`` with one column per query.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.range_scan import (DEFAULT_TILE_N, blocks_view,
                                            check_tiling, check_visits,
                                            compared_rows, scan_cuda,
                                            vertical_cuda, visit_cuda)


def multi_scan_tiles(
    data_cm: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
    m: int | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """Fused full scan of a query batch.

    Args:
      data_cm: (m_pad, n_pad) columnar data; m_pad % 8 == 0, n_pad % tile_n == 0.
      lower, upper: (m_pad, Q) finite bounds, one column per query.
      m: compare rows [0, m) only (the real dims; the default compares all
        m_pad rows, which gives the same masks under the padding contract).
      rows: how many dims any query of the batch constrains, where the
        caller knows it (it sizes the kernel's registers; any value gives
        the same masks, one too low costs further passes over the data).

    Returns:
      (Q, n_pad) int8 match masks, row q = query q.
    """
    m_pad, n_pad = data_cm.shape
    check_tiling(m_pad, n_pad, tile_n)
    if lower.ndim != 2 or lower.shape[0] != m_pad or lower.shape[1] < 1 \
            or upper.shape != lower.shape:
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"are not ({m_pad}, Q >= 1)")
    if not data_cm.is_cuda:
        r = compared_rows(m, m_pad)
        return _ref.multi_scan_ref(data_cm[:r], lower[:r], upper[:r])
    return scan_cuda("multi_scan_tiles", data_cm, lower, upper, m, rows)


def multi_scan_vertical(
    data_cm: torch.Tensor,
    dim_ids: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
    rows: int | None = None,
) -> torch.Tensor:
    """Batched partial-match vertical scan.

    Args:
      data_cm: (m_pad, n_pad) columnar data.
      dim_ids: (Q, D_max) int32 per-query constrained-dimension ids. Rows with
        fewer than D_max constrained dims pad by *repeating* one of the
        query's own dims (AND is idempotent); a match-all query uses dim 0,
        whose bounds column carries dtype extrema and accepts everything.
      lower, upper: (m_pad, Q) finite bounds (indexed by dim_ids).
      rows: how many distinct dims ``dim_ids`` lists, where the caller
        knows it (it sizes the kernel's registers; any value gives the same
        masks, one too low costs further passes over the data).

    Returns:
      (Q, n_pad) int8 match masks over each query's constrained dims.
    """
    m_pad, n_pad = data_cm.shape
    check_tiling(m_pad, n_pad, tile_n)
    if dim_ids.ndim != 2 or dim_ids.shape[1] < 1:
        raise ValueError(f"dim_ids must be (Q, D_max >= 1), got "
                         f"{tuple(dim_ids.shape)}")
    q_n = dim_ids.shape[0]
    if lower.shape != (m_pad, q_n) or upper.shape != (m_pad, q_n):
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"!= ({m_pad}, {q_n})")
    if not data_cm.is_cuda:
        return _ref.multi_scan_vertical_ref(data_cm, dim_ids, lower, upper)
    return vertical_cuda("multi_scan_vertical", data_cm, dim_ids, lower, upper,
                         rows)


def multi_scan_visit(
    data_cm: torch.Tensor,
    query_ids: torch.Tensor,
    block_ids: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """Batched two-phase refinement: visit each (query, block) pair once.

    Args:
      data_cm: (m_pad, n_pad) columnar data, n_pad % tile_n == 0.
      query_ids: (V,) int32 — which query's bounds each visit uses.
      block_ids: (V,) int32 tile indices; padding entries are negative
        (clamped to 0; callers drop their output rows).
      lower, upper: (m_pad, Q) finite bounds, one column per query.

    Returns:
      (V, tile_n) int8 per-visit masks.
    """
    m_pad = check_visits(data_cm, block_ids, tile_n)
    if query_ids.shape != block_ids.shape:
        raise ValueError(f"query_ids {tuple(query_ids.shape)} != block_ids "
                         f"{tuple(block_ids.shape)}")
    if lower.ndim != 2 or lower.shape[0] != m_pad or lower.shape[1] < 1 \
            or upper.shape != lower.shape:
        raise ValueError(f"bounds {tuple(lower.shape)}, {tuple(upper.shape)} "
                         f"are not ({m_pad}, Q >= 1)")
    if not data_cm.is_cuda:
        return _ref.multi_scan_blocks_ref(blocks_view(data_cm, tile_n),
                                          query_ids, block_ids, lower, upper)
    return visit_cuda("multi_scan_visit", data_cm, query_ids, block_ids, lower,
                      upper, tile_n)

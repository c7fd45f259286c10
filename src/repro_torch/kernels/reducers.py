"""Batched masked reducers over (Q, n_pad) match masks.

Ports ``repro/kernels/reducers.py``: a spec's reducer turns the match masks
into its payload — top-k values/positions, an aggregate — inside the same
counted op as the scan that produced them, so only O(Q·k) / O(Q) bytes cross
the device->host boundary.

Two kernels (``csrc/reducers.cu``), both reading the values row once per
batch:

  * ``masked_fill_tiles`` — matching lanes keep the attribute value,
    non-matching lanes take the reduction identity; feeds the top-k.
  * ``masked_agg_tiles``  — sum/min/max per query: per-block partials on the
    card, then one torch reduce over the small partial array. No float
    atomics, so repeated runs give bit-identical sums.

The top-k selection is not a kernel of the reference either (it calls
``jax.lax.top_k``), so ``torch.topk`` selects — on a composite key that
makes its order exact: ties order by ascending position, as the reference's
does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.range_scan import (DEFAULT_TILE_N, LANES, VEC,
                                            block_threads, cuda_input)

AGG_FILL = _ref.AGG_FILL
_AGG_OPS = ("sum", "min", "max")  # the C launcher's op codes, in order

# Rows of the (Q, n_pad) top-k key built at once: bounds the int64 key's
# memory at 8 * 2**27 bytes whatever the batch size.
_TOPK_CHUNK_ELEMS = 1 << 27


def _check_masks(masks: torch.Tensor, values: torch.Tensor, tile_n: int):
    q_n, n_pad = masks.shape
    if q_n < 1 or tile_n % LANES or n_pad % tile_n:
        raise ValueError(f"masks {tuple(masks.shape)} / tile_n={tile_n}: need "
                         f"Q >= 1, n_pad % tile_n == 0, tile_n % {LANES} == 0")
    if values.shape != (n_pad,):
        raise ValueError(f"values {tuple(values.shape)} != ({n_pad},)")
    return q_n, n_pad


def masked_fill_tiles(
    masks: torch.Tensor,
    values: torch.Tensor,
    fill: float,
    *,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """Batched masked fill (the top-k front half).

    Args:
      masks: (Q, n_pad) int8 match masks, n_pad % tile_n == 0.
      values: (n_pad,) attribute values (one dataset row, storage order).
      fill: value for non-matching lanes (the reduction identity).

    Returns:
      (Q, n_pad) float32 filled values.
    """
    q_n, n_pad = _check_masks(masks, values, tile_n)
    if not masks.is_cuda:
        return _ref.masked_fill_ref(masks, values, fill)
    dev = masks.device
    mk = cuda_input(masks, torch.int8, "masks", dev)
    val = cuda_input(values.to(torch.float32), torch.float32, "values", dev)
    out = torch.empty((q_n, n_pad), dtype=torch.float32, device=dev)
    _build.launch("masked_fill_tiles", "mdrq_masked_fill", dev, mk, val,
                  float(fill), n_pad, q_n, out, block_threads(n_pad))
    return out


def masked_agg_tiles(
    masks: torch.Tensor,
    values: torch.Tensor,
    op: str,
    *,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """Batched masked aggregate.

    Args:
      masks: (Q, n_pad) int8 match masks.
      values: (n_pad,) attribute values.
      op: "sum" | "min" | "max".

    Returns:
      (Q,) float32 aggregates; the reduction identity where nothing matches.
    """
    if op not in _AGG_OPS:
        raise ValueError(f"unknown agg op {op!r}; options: {_AGG_OPS}")
    q_n, n_pad = _check_masks(masks, values, tile_n)
    if not masks.is_cuda:
        return _ref.masked_agg_ref(masks, values, op)
    dev = masks.device
    mk = cuda_input(masks, torch.int8, "masks", dev)
    val = cuda_input(values.to(torch.float32), torch.float32, "values", dev)
    threads = block_threads(n_pad)
    partials = torch.empty((q_n, n_pad // (VEC * threads)), dtype=torch.float32,
                           device=dev)
    _build.launch("masked_agg_tiles", "mdrq_masked_agg", dev, mk, val,
                  _AGG_OPS.index(op), float(AGG_FILL[op]), n_pad, q_n,
                  partials, threads)
    if op == "sum":
        return partials.sum(dim=-1)
    return partials.amin(dim=-1) if op == "min" else partials.amax(dim=-1)


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order is the floats' order."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def topk_ascending_ties(values: torch.Tensor, k: int,
                        largest: bool) -> torch.Tensor:
    """(Q, n) float32 -> (Q, k) int64 positions of the k largest (smallest)
    values, in descending (ascending) value order, ties by ascending position.

    ``torch.topk`` leaves the order of equal keys open, so it selects on an
    int64 composite instead: the order-preserving bits of the key (the value,
    negated when ``largest`` is False, as the reference does) in the high 32
    bits and ``2**32 - 1 - position`` in the low 32. Every composite is
    distinct, and its descending order is exactly the wanted one.
    """
    q_n, n = values.shape
    rank = (2 ** 32 - 1) - torch.arange(n, dtype=torch.int64,
                                        device=values.device)
    rows = max(1, _TOPK_CHUNK_ELEMS // n)
    idx = torch.empty((q_n, k), dtype=torch.int64, device=values.device)
    for r in range(0, q_n, rows):
        key = values[r: r + rows] if largest else -values[r: r + rows]
        comp = _ordered_bits(key).to(torch.int64) * (2 ** 32) + rank
        idx[r: r + rows] = torch.topk(comp, k, dim=-1).indices
    return idx


def masked_topk(masks, values, k: int, largest: bool, *, tile_n: int,
                backend: str):
    """(Q, n_pad) masks + (n_pad,) values -> ((Q,k) vals, (Q,k) int32 idx,
    (Q,) int32 counts).

    Matching lanes keep their value (the fill kernel, or its plain version
    under ``backend="torch"``), the composite-key top-k selects the k
    extremes, and the per-query match count rides along so the host
    finalizer can truncate queries with fewer than k matches. Positions are
    storage-order column indices; ties order by ascending position.
    """
    fill = float("-inf") if largest else float("inf")
    if backend == "torch":
        filled = _ref.masked_fill_ref(masks, values, fill)
    else:
        filled = masked_fill_tiles(masks, values, fill, tile_n=tile_n)
    kk = min(int(k), filled.shape[-1])
    idx = topk_ascending_ties(filled, kk, largest)
    vals = torch.gather(filled, 1, idx)
    counts = masks.ne(0).sum(dim=-1, dtype=torch.int32)
    return vals, idx.to(torch.int32), counts


def masked_agg(masks, values, op: str, *, tile_n: int, backend: str):
    """(Q, n_pad) masks + (n_pad,) values -> ((Q,) aggregates, (Q,) counts).

    Empty matches produce the reduction identity; the host finalizer turns
    them into 0.0 (sum) / NaN (min, max) using the count.
    """
    if backend == "torch":
        agg = _ref.masked_agg_ref(masks, values, op)
    else:
        agg = masked_agg_tiles(masks, values, op, tile_n=tile_n)
    counts = masks.ne(0).sum(dim=-1, dtype=torch.int32)
    return agg, counts

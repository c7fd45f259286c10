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

The visit-shaped reducers (``visit_*``) serve the two-phase paths: they take
the (V, tile_n) masks of a (query, block) visit list and reduce them per
query. They are plain torch ops in both packages (the reference's are jnp
segment reductions). Float sums never go through atomics: each visit's row
reduces on its own, then each query's visits reduce through the host-built
``visit_index`` table in a fixed order, so repeated sums are bit-identical.
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
    pos = torch.arange(n, dtype=torch.int64, device=values.device)
    rows = max(1, _TOPK_CHUNK_ELEMS // n)
    idx = torch.empty((q_n, k), dtype=torch.int64, device=values.device)
    for r in range(0, q_n, rows):
        key = values[r: r + rows] if largest else -values[r: r + rows]
        idx[r: r + rows] = torch.topk(_composite(key, pos), k, dim=-1).indices
    return idx


def _composite(key: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 top-k key: the order-preserving bits of the float32 ``key`` in
    the high 32 bits, ``2**32 - 1 - pos`` in the low 32 (``pos`` < 2**32,
    broadcast against ``key``). Distinct positions give distinct composites;
    descending order is value order, ties by ascending position."""
    return _ordered_bits(key).to(torch.int64) * (2 ** 32) \
        + ((2 ** 32 - 1) - pos)


def _split_composite(comp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``_composite`` -> (float32 key, int64 position)."""
    bits = (comp >> 32).to(torch.int32)  # floor: the low half is >= 0
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return key, (2 ** 32 - 1) - (comp & 0xFFFFFFFF)


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


def merge_shard_topk(parts, n_local: int, k: int, largest: bool):
    """Merge the shards' ``masked_topk`` payloads into one top-k.

    ``parts`` lists each shard's ((Q, kk) values, (Q, kk) int32 local
    positions, (Q,) counts), in shard order, on one device. Positions become
    global (``s * n_local`` added); a lane past its shard's match count is a
    fill lane and never outranks a real candidate; the k best of the
    (Q, D * kk) candidates are selected on the composite key, so ties order
    by ascending global position — the order one device's ``masked_topk``
    gives. Returns ((Q, k') values, (Q, k') int32 positions, (Q,) int32
    counts), k' = min(k, D * kk); lanes past a query's count are padding,
    which the finalizer cuts.
    """
    d, kk = len(parts), parts[0][0].shape[-1]
    dev = parts[0][0].device
    vals = torch.cat([v for v, _, _ in parts], dim=1)            # (Q, D*kk)
    shard = torch.arange(d, device=dev).repeat_interleave(kk)     # (D*kk,)
    pos = torch.cat([i for _, i, _ in parts], dim=1).to(torch.int64) \
        + shard * n_local
    cnt = torch.stack([c for _, _, c in parts], dim=1)            # (Q, D)
    live = torch.arange(kk, device=dev).repeat(d) < cnt[:, shard]
    comp = torch.where(live, _composite(vals if largest else -vals, pos),
                       torch.iinfo(torch.int64).min)
    top = torch.topk(comp, min(int(k), d * kk), dim=-1).values
    key, gpos = _split_composite(top)
    total = cnt.sum(dim=1, dtype=torch.int32)
    return (key if largest else -key), gpos.to(torch.int32), total


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


# -- tombstone folds (the mutable data plane) ---------------------------------

def fold_tombstones(masks: torch.Tensor, tomb: torch.Tensor) -> torch.Tensor:
    """AND tombstone flags into match masks, in place: a tombstoned object
    never matches. Returns ``masks``.

    ``tomb`` is int8 (1 = dead) and broadcasts against ``masks`` — (n_pad,)
    against the (Q, n_pad) scan masks, or a gathered (V, tile_n) block
    against the visit masks. The masks are the fresh output of the op's mask
    kernel, so folding in place saves a second (Q, n_pad) array. Runs inside
    the fused counted ops, before the spec's reducer, so every payload shape
    sees the tombstones at no extra counted launch and no host sync.
    """
    return masks.mul_((tomb == 0).to(masks.dtype))


def gather_tomb_blocks(tomb: torch.Tensor, bids: torch.Tensor,
                       tile_n: int) -> torch.Tensor:
    """(V, tile_n) tombstone flags of the visited blocks (padding visits ->
    block 0; harmless — the visit reducers mask them through ``valid``)."""
    return tomb.reshape(-1, tile_n)[bids.long().clamp(min=0)]


# -- visit-shaped reducers (two-phase paths) ----------------------------------
# Padding visits (block -1, clamped to block 0) carry ``valid == 0`` and are
# masked out. Float temporaries are built ``_TOPK_CHUNK_ELEMS`` elements at a
# time, so a broad query that visits every block never materializes a
# (V, tile_n) float32 or int64 array in one piece.

def _visit_chunks(n_visit: int, tile_n: int):
    step = max(1, _TOPK_CHUNK_ELEMS // tile_n)
    return (slice(v0, v0 + step) for v0 in range(0, n_visit, step))


def gather_visit_values(data_cm, dim: int, bids, tile_n: int):
    """(V, tile_n) attribute values of the visited blocks (padding -> block 0,
    masked out downstream via ``valid``)."""
    n_blocks = data_cm.shape[1] // tile_n
    return data_cm[dim].reshape(n_blocks, tile_n)[bids.long().clamp(min=0)]


def _live(masks, valid):
    return torch.logical_and(masks != 0, valid[:, None] > 0)


def visit_mask_counts(masks, qids, valid, n_queries: int):
    """(V, tile_n) visit masks -> (n_queries,) int32 per-query match counts
    (integer adds: exact in any order)."""
    per_visit = masks.ne(0).sum(dim=-1, dtype=torch.int32) * valid
    out = torch.zeros((n_queries,), dtype=torch.int32, device=masks.device)
    return out.index_add_(0, qids.long(), per_visit.to(torch.int32))


def _gather_by_query(per_visit, visit_index, fill):
    """(V, ...) per-visit values -> (Q, M, ...) through the visit-index table,
    whose empty slots point one past the last row (filled with ``fill``)."""
    pad = torch.full((1, *per_visit.shape[1:]), fill, dtype=per_visit.dtype,
                     device=per_visit.device)
    return torch.cat([per_visit, pad])[visit_index.long()]


def visit_agg(masks, data_cm, dim: int, bids, valid, visit_index, op: str,
              tile_n: int):
    """Aggregate attribute ``dim`` over each query's visit masks ->
    (Q,) float32 (the reduction identity where nothing matches).

    Each visit row reduces to one partial; the partials of a query reduce
    through ``visit_index`` in slot order."""
    fill = AGG_FILL[op]
    red = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[op]
    per_visit = torch.empty((masks.shape[0],), dtype=torch.float32,
                            device=masks.device)
    for sl in _visit_chunks(masks.shape[0], tile_n):
        vals = gather_visit_values(data_cm, dim, bids[sl], tile_n)
        filled = torch.where(_live(masks[sl], valid[sl]),
                             vals.to(torch.float32), fill)
        per_visit[sl] = red(filled, dim=-1)
    return red(_gather_by_query(per_visit, visit_index, fill), dim=-1)


def visit_topk(masks, data_cm, dim: int, bids, valid, visit_index, k: int,
               largest: bool, tile_n: int):
    """Per-query top-k of attribute ``dim`` over scattered visit masks, in
    two stages, as the reference selects.

    Stage 1 reduces each visit row to its own top-k' (k' = min(k, tile_n)).
    Stage 2 gathers the partials through ``visit_index`` into (Q, M·k') and
    re-selects the global top-k per query. Both stages select on the
    composite key with position = ``block * tile_n + offset`` (the storage
    position, permuted for the trees), so ties order by ascending position
    exactly as the reference's two ``top_k`` calls order them: visits of a
    query sit in the table by ascending block id.

    Returns ((Q, k'') float32 values, (Q, k'') int32 positions),
    k'' = min(k, M·k').
    """
    fill = float("-inf") if largest else float("inf")
    k1 = min(int(k), tile_n)
    offsets = torch.arange(tile_n, dtype=torch.int64, device=masks.device)
    comp1 = torch.empty((masks.shape[0], k1), dtype=torch.int64,
                        device=masks.device)
    for sl in _visit_chunks(masks.shape[0], tile_n):
        b = bids[sl].long().clamp(min=0)
        vals = gather_visit_values(data_cm, dim, b, tile_n).to(torch.float32)
        key = torch.where(_live(masks[sl], valid[sl]), vals, fill)
        if not largest:
            key = -key
        comp = _composite(key, b[:, None] * tile_n + offsets)
        comp1[sl] = torch.topk(comp, k1, dim=-1).values
    # empty table slots can never outrank a real entry
    g = _gather_by_query(comp1, visit_index, torch.iinfo(torch.int64).min)
    q_n, m_vis, _ = g.shape
    k2 = min(int(k), m_vis * k1)
    top = torch.topk(g.reshape(q_n, m_vis * k1), k2, dim=-1).values
    key, pos = _split_composite(top)
    return (key if largest else -key), pos.to(torch.int32)

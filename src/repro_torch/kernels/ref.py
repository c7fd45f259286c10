"""Plain PyTorch versions of the MDRQ kernels.

Each function is the semantic ground truth its CUDA kernel is held against:
the kernel wrappers run these on CPU tensors, the ops run them on any device
under ``backend="torch"``, and ``chip_smoke.py`` compares every kernel with
its plain version on the card. Masks are discrete, so equality is exact;
the decode attention (``kv_visit_attention_ref``) is float arithmetic and is
held within a stated tolerance.
"""
from __future__ import annotations

import torch

from repro_torch import numerics

# Reduction identities, keyed by agg op.
AGG_FILL = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def range_scan_ref(data_cm: torch.Tensor, lower: torch.Tensor,
                   upper: torch.Tensor) -> torch.Tensor:
    """(m, n) columnar data, (m,) or (m, 1) bounds -> (n,) int8 mask, 1 where
    ``all_j lower_j <= x_ji <= upper_j``."""
    lo = lower.reshape(-1, 1).to(data_cm.dtype)
    up = upper.reshape(-1, 1).to(data_cm.dtype)
    ok = torch.logical_and(data_cm >= lo, data_cm <= up)
    return ok.all(dim=0).to(torch.int8)


def range_scan_rows_ref(data_rm: torch.Tensor, lower: torch.Tensor,
                        upper: torch.Tensor) -> torch.Tensor:
    """(n, m) row-major data, (1, m) bounds -> (n,) int8 mask, 1 where
    ``all_j lower_j <= x_ij <= upper_j``."""
    lo = lower.reshape(1, -1).to(data_rm.dtype)
    up = upper.reshape(1, -1).to(data_rm.dtype)
    return ((data_rm >= lo) & (data_rm <= up)).all(dim=1).to(torch.int8)


def multi_scan_ref(data_cm: torch.Tensor, lower: torch.Tensor,
                   upper: torch.Tensor) -> torch.Tensor:
    """(m, n) data, (m, Q) query-minor bounds -> (Q, n) int8 masks."""
    # Per-dimension accumulation: one (Q, n) sweep per dim instead of a
    # (Q, m, n) broadcast.
    lo = lower.T.to(data_cm.dtype)  # (Q, m)
    up = upper.T.to(data_cm.dtype)
    acc = None
    for j in range(data_cm.shape[0]):
        row = data_cm[j][None, :]  # (1, n)
        ok = torch.logical_and(row >= lo[:, j, None], row <= up[:, j, None])
        acc = ok if acc is None else torch.logical_and(acc, ok)
    return acc.to(torch.int8)


def multi_scan_vertical_ref(data_cm: torch.Tensor, dim_ids: torch.Tensor,
                            lower: torch.Tensor,
                            upper: torch.Tensor) -> torch.Tensor:
    """(m, n) data, (Q, D_max) constrained-dim ids (padding repeats a valid
    dim of the same query), (m, Q) bounds -> (Q, n) int8 masks over each
    query's listed dims."""
    lo_t = lower.T.to(data_cm.dtype)  # (Q, m)
    up_t = upper.T.to(data_cm.dtype)
    acc = None
    for j in range(dim_ids.shape[1]):
        d = dim_ids[:, j].long()     # (Q,)
        rows = data_cm[d]            # (Q, n) — one constrained dim per query
        lo = torch.gather(lo_t, 1, d[:, None])  # (Q, 1)
        up = torch.gather(up_t, 1, d[:, None])
        ok = torch.logical_and(rows >= lo, rows <= up)
        acc = ok if acc is None else torch.logical_and(acc, ok)
    return acc.to(torch.int8)


def masked_fill_ref(masks: torch.Tensor, values: torch.Tensor,
                    fill: float) -> torch.Tensor:
    """(Q, n) int8 masks, (n,) values -> (Q, n) float32: the value where the
    mask is set, ``fill`` elsewhere."""
    return torch.where(masks != 0, values[None, :].to(torch.float32),
                       torch.tensor(fill, dtype=torch.float32,
                                    device=masks.device))


def masked_agg_ref(masks: torch.Tensor, values: torch.Tensor,
                   op: str) -> torch.Tensor:
    """(Q, n) int8 masks, (n,) values -> (Q,) float32 aggregates (the
    reduction identity where nothing matches)."""
    filled = masked_fill_ref(masks, values, AGG_FILL[op])
    if op == "sum":
        return filled.sum(dim=-1)
    return filled.amin(dim=-1) if op == "min" else filled.amax(dim=-1)


# Visits of the block-visit plain version gathered at once: bounds its
# (chunk, tile_n) float32 temporaries whatever the visit count.
_VISIT_CHUNK_ELEMS = 1 << 26


def multi_scan_blocks_ref(data_blocks: torch.Tensor, query_ids: torch.Tensor,
                          block_ids: torch.Tensor, lower: torch.Tensor,
                          upper: torch.Tensor) -> torch.Tensor:
    """(n_blocks, m, tn) columnar leaf blocks (a view is fine), (V,) query
    ids, (V,) block ids (negative = padding, clamped to block 0), (m, Q)
    query-minor bounds -> (V, tn) int8 per-visit masks."""
    n_visit, tn = block_ids.shape[0], data_blocks.shape[2]
    out = torch.empty((n_visit, tn), dtype=torch.int8, device=data_blocks.device)
    bids = block_ids.long().clamp(min=0)
    qids = query_ids.long()
    lo_t = lower.T.to(data_blocks.dtype)  # (Q, m)
    up_t = upper.T.to(data_blocks.dtype)
    step = max(1, _VISIT_CHUNK_ELEMS // tn)
    for v0 in range(0, n_visit, step):
        b, q = bids[v0: v0 + step], qids[v0: v0 + step]
        lo, up = lo_t[q], up_t[q]  # (chunk, m)
        acc = None
        for j in range(data_blocks.shape[1]):
            rows = data_blocks[:, j, :][b]  # (chunk, tn)
            ok = torch.logical_and(rows >= lo[:, j, None], rows <= up[:, j, None])
            acc = ok if acc is None else torch.logical_and(acc, ok)
        out[v0: v0 + step] = acc.to(torch.int8)
    return out


def va_filter_packed_ref(packed: torch.Tensor, cell_lo: torch.Tensor,
                         cell_hi: torch.Tensor, m: int) -> torch.Tensor:
    """(w, n) int32 packed codes (word w holds dims [16w, 16w+16) in 2-bit
    fields), (m,) int32 query cell bounds -> (n,) int8 candidate mask."""
    return multi_va_filter_packed_ref(packed, cell_lo.reshape(-1, 1),
                                      cell_hi.reshape(-1, 1), m)[0]


def multi_va_filter_packed_ref(packed: torch.Tensor, cell_lo: torch.Tensor,
                               cell_hi: torch.Tensor, m: int) -> torch.Tensor:
    """(w, n) int32 packed codes, (m_s, Q) int32 query-minor cell bounds
    (rows from m on are never read) -> (Q, n) int8 candidate masks: 1 where
    every dim's code lies in the query's [cell_lo, cell_hi]."""
    # deferred: va_filter's wrappers import this module
    from repro_torch.kernels.va_filter import (BITS_PER_DIM, CODE_MASK,
                                               DIMS_PER_WORD)
    n = packed.shape[1]
    lo = cell_lo.to(torch.int32)
    hi = cell_hi.to(torch.int32)
    acc = torch.ones((lo.shape[1], n), dtype=torch.bool, device=packed.device)
    for d in range(m):
        wi, k = divmod(d, DIMS_PER_WORD)
        field = (packed[wi] >> (BITS_PER_DIM * k)) & CODE_MASK  # (n,)
        ok = torch.logical_and(field[None, :] >= lo[d, :, None],
                               field[None, :] <= hi[d, :, None])
        acc = torch.logical_and(acc, ok)
    return acc.to(torch.int8)


def kv_visit_attention_ref(q: torch.Tensor, k_blocks: torch.Tensor,
                           v_blocks: torch.Tensor, block_ids: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Decode attention over only the listed key blocks.

    q: (B, KV, G, hd); k/v_blocks: (B, KV, nb, bs, hd), any strides (the
    model passes a block-major view of its token-major cache);
    block_ids: (B, KV, n_visit) (-1 = padding: reads block 0, masked);
    pos: (B,). Scores and softmax in float32; masked keys take the finite
    ``mask_fill(bfloat16)``. Returns (B, KV, G, hd) in q's dtype.
    """
    b, kv, g, hd = q.shape
    bs = k_blocks.shape[3]
    ids = block_ids.long().clamp(min=0)
    k_sel = torch.take_along_dim(k_blocks, ids[..., None, None], dim=2)
    v_sel = torch.take_along_dim(v_blocks, ids[..., None, None], dim=2)
    slots = ids[..., None] * bs + torch.arange(bs, device=q.device)
    valid = (slots <= pos.long()[:, None, None, None]) \
        & (block_ids[..., None] >= 0)
    s = torch.einsum("bkgh,bkjth->bkgjt", q.float(), k_sel.float()) \
        * (hd ** -0.5)
    s = torch.where(valid[:, :, None, :, :], s,
                    numerics.mask_fill(torch.bfloat16))
    nv = block_ids.shape[-1]
    s = s.reshape(b, kv, g, nv * bs)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bkth->bkgh", w,
                       v_sel.float().reshape(b, kv, nv * bs, hd))
    return out.to(q.dtype)

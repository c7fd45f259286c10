"""Plain PyTorch versions of the MDRQ kernels.

Each function is the semantic ground truth its CUDA kernel is held against:
the kernel wrappers run these on CPU tensors, the ops run them on any device
under ``backend="torch"``, and ``chip_smoke.py`` compares every kernel with
its plain version on the card. Masks are discrete, so equality is exact.
"""
from __future__ import annotations

import torch

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

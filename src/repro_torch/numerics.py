"""Dtype-aware numeric sentinels.

A hardcoded extremum such as ``3e38`` is only finite in some dtypes: float32's
extrema round up to inf under a bfloat16 cast, so a "large but finite" literal
can turn into the +inf that object-padding sentinels use and make padding
match real queries. Every sentinel is derived from ``torch.finfo`` of the dtype
that will hold it instead.

Query-bound sanitization (+-inf -> finite extrema of the comparison dtype)
lives in ``core.types.finite_query_bounds``, built on these helpers.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_torch_dtype", "finite_min", "finite_max", "mask_fill"]


def as_torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype`` (accepts torch and numpy dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), np.dtype(dtype))).dtype


def finite_min(dtype) -> float:
    """Most negative finite value representable in ``dtype``, as a float."""
    return float(torch.finfo(as_torch_dtype(dtype)).min)


def finite_max(dtype) -> float:
    """Largest finite value representable in ``dtype``, as a float."""
    return float(torch.finfo(as_torch_dtype(dtype)).max)


def mask_fill(dtype=torch.bfloat16) -> float:
    """Additive attention-mask fill: large negative, finite in ``dtype``.

    Pass the narrowest dtype the masked scores may ever be cast to (the
    default, bfloat16, survives bf16 <-> f32 round trips). The 0.7 factor
    keeps headroom so adding real score magnitudes on top of the fill cannot
    overflow ``dtype`` before the softmax zeroes the lane; ``exp`` of any
    value at this scale underflows to exactly 0 in every float dtype.
    """
    return 0.7 * finite_min(dtype)

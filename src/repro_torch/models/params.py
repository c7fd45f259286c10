"""Parameter initialisers for the port's models.

Ports ``repro/models/params.py`` for one device: a parameter is a plain
tensor (no logical sharding axes, no ``Param`` wrapper), and random draws
come from an explicit ``torch.Generator``. The two packages draw different
numbers from the same seed; the parity tests carry the reference's weights
across with ``models.convert.from_jax_params``.
"""
from __future__ import annotations

import math

import torch

TRUNC = 2.0  # truncated normal on [-TRUNC, TRUNC], as the reference draws


def truncated_normal(shape, generator: torch.Generator,
                     device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32, by the inverse CDF of a
    uniform draw from ``generator``."""
    lo = 0.5 * (1.0 + math.erf(-TRUNC / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(TRUNC / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return x.clamp_(-TRUNC, TRUNC)


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal times ``scale`` (default ``fan_in ** -0.5``, fan_in
    = the first axis), drawn in float32 and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return (truncated_normal(shape, generator, device) * s).to(dtype)


def ones_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def leaves(tree):
    """The tensors of a nested dict/list parameter tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))

"""Sharding context for the in-model sharding constraints.

Ports ``repro/models/shardctx.py``. Layer code calls ``constrain`` at the
points where the reference calls ``with_sharding_constraint``; the launcher
or the dry run sets the mesh first. With no mesh set (tests, one-device
runs) every constraint is the identity, so model code stays mesh-agnostic.
With a mesh set, ``constrain`` redistributes a DTensor to the spec's
placements; a plain tensor then raises, so no constraint is dropped unseen.

``ctx`` with a mesh also enters DTensor's implicit replication: a plain
tensor that layer code makes, such as an ``arange`` of positions, holds the
same values on every rank, so it joins DTensor ops as ``Replicate``.
``set_ctx`` sets the mesh alone.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.params import P, placements

_CTX: dict = {"mesh": None, "batch_axes": ("data",)}


def set_ctx(mesh: Optional[DeviceMesh], batch_axes: tuple = ("data",)) -> None:
    _CTX["mesh"] = mesh
    _CTX["batch_axes"] = tuple(batch_axes)


@contextlib.contextmanager
def ctx(mesh: Optional[DeviceMesh], batch_axes: tuple = ("data",)):
    prev = dict(_CTX)
    set_ctx(mesh, batch_axes)
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.update(prev)


def mesh() -> Optional[DeviceMesh]:
    return _CTX["mesh"]


def batch_axes() -> tuple:
    return _CTX["batch_axes"]


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``x`` redistributed to ``spec``'s placements when a mesh is set;
    ``x`` itself otherwise."""
    m = _CTX["mesh"]
    if m is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain({spec}) on a plain {type(x).__name__} "
                        f"under a mesh: the constraint would be dropped")
    return _Constrain.apply(x, m, placements(spec, m))


def matmul_out(y: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` (x (..., k), w (k, n)) laid out, value and gradient,
    as x's leading dims and w's columns: split where x splits a leading
    dim, else where w splits its columns (a column-parallel product),
    else replicated, so a contraction split over ranks is summed at once
    (a row-parallel product). For DTensors under a mesh. DTensor picks
    each op's layout on its own, and with both operands replicated it may
    split the contraction and carry the partial sums on."""
    m = _CTX["mesh"]
    lead = x.dim() - 1
    pls = []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim < lead:
            pls.append(px)
        elif pw.is_shard(1):
            pls.append(type(pw)(y.dim() - 1))
        else:
            pls.append(Replicate())
    return _Constrain.apply(y, m, tuple(pls))


class _Constrain(torch.autograd.Function):
    """Redistribute to ``pls``, and the gradient too, as a JAX sharding
    constraint lays out the cotangent like the value (DTensor's own
    redistribute leaves the gradient's layout to the ops behind it)."""

    @staticmethod
    def forward(ctx, x, mesh, pls):
        ctx.mesh, ctx.pls = mesh, pls
        return x.redistribute(mesh, pls).view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.pls), None, None


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` gathered wherever a mesh dim splits it,
    its gradient too (``x`` itself when it is a plain tensor)."""
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def axes_size(axes) -> int:
    """The number of ranks along the mesh axes ``axes`` (a name or a
    tuple of names) of the context's mesh."""
    m = _CTX["mesh"]
    names = list(m.mesh_dim_names)
    axes = (axes,) if isinstance(axes, str) else axes
    n = 1
    for a in axes:
        n *= m.size(names.index(a))
    return n


def batch_model_axes() -> Optional[tuple]:
    """Mesh axes for 2D batch sharding (batch over data axes + model), or
    None when no mesh is set."""
    if _CTX["mesh"] is None:
        return None
    return tuple(_CTX["batch_axes"]) + ("model",)

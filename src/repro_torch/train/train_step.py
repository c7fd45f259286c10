"""Train-step builder: gradients + microbatch accumulation + AdamW.

Ports ``repro/train/train_step.py`` for one device. Gradients come from
``torch.autograd.grad`` on the parameter-dtype leaves (the reference's
``jax.value_and_grad`` of ``loss_fn``); ``grad_accum`` microbatches
accumulate in float32 and are divided by ``grad_accum``, in the order the
reference's ``lax.scan`` adds them. The metrics stay on the device (the
learning rate is a host float): reading them is the caller's counted sync.

``compressed_psum`` is the reference's int8 gradient all-reduce over a mesh
axis (the reference's runs inside ``shard_map``; here each rank of a
``torch.distributed`` world calls it on its local gradients).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models import shardctx
from repro_torch.models.params import leaves, map_tree, unflatten
from repro_torch.train.optimizer import OptConfig, adamw_update

F32 = torch.float32


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    split = {k: x.reshape(accum, b // accum, *x.shape[1:])
             for k, x in batch.items()}
    return [{k: x[i] for k, x in split.items()} for i in range(accum)]


def _value_and_grad(model, params, batch):
    """-> (total loss, metrics, grads in ``leaves(params)`` order), the
    loss and metrics detached."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        total, metrics = model.loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(total, live)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(model, opt_cfg: OptConfig,
                    grad_accum: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics) with metrics ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` and
    ``total_loss``. ``batch`` is a dict of tensors on the model's device."""

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = _value_and_grad(model, params, batch)
        else:
            g_acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in leaves(params)]
            loss_acc = torch.zeros((), dtype=F32, device=model.device)
            for mb in _split_microbatches(batch, grad_accum):
                loss, _, g = _value_and_grad(model, params, mb)
                g_acc = [a + b.float() for a, b in zip(g_acc, g)]
                loss_acc = loss_acc + loss
            grads = [g / grad_accum for g in g_acc]
            loss = loss_acc / grad_accum
            metrics = {"loss": loss,
                       "aux_loss": torch.zeros((), dtype=F32,
                                               device=model.device)}
        new_params, new_opt, opt_metrics = adamw_update(
            params, unflatten(params, grads), opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["total_loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale), the scale a
    float32 device scalar."""
    gf = g.float()
    scale = torch.clamp(gf.abs().amax() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads, axis_name: str, mesh=None):
    """All-reduce gradients in int8 over the mesh dim ``axis_name`` (of
    ``mesh``, default the ``shardctx`` mesh): quantize -> int32 sum ->
    dequantize, the mean over the dim's ranks.

    Per leaf, as the reference: the float32 scale ``max(|g|) / 127``
    (at least 1e-12) is MAX-reduced so every rank dequantizes alike, the
    codes are ``round`` (half to even) clipped to [-127, 127] as int32 and
    SUM-reduced, and the result is ``codes * scale / n``. Communication
    drops 4x against float32.
    """
    mesh = shardctx.mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh (argument or "
                         "shardctx)")
    group = mesh.get_group(axis_name)
    n = float(dist.get_world_size(group))

    def one(g):
        gf = g.float()
        scale = torch.clamp(gf.abs().amax() / 127.0, min=1e-12)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return (q.to(F32) * scale) / n

    return map_tree(grads, one)

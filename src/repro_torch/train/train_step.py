"""Train-step builder: gradients + microbatch accumulation + AdamW.

Ports ``repro/train/train_step.py`` for one device. Gradients come from
``torch.autograd.grad`` on the parameter-dtype leaves (the reference's
``jax.value_and_grad`` of ``loss_fn``); ``grad_accum`` microbatches
accumulate in float32 and are divided by ``grad_accum``, in the order the
reference's ``lax.scan`` adds them. The metrics stay on the device (the
learning rate is a host float): reading them is the caller's counted sync.

The reference's ``compressed_psum`` all-reduces int8 gradients over a mesh
axis name inside ``shard_map``; its one-process counterpart is a
``core.distributed.DataMesh`` collective, which a later PR adds. The int8
quantizer it is built on, ``quantize_int8``, is here.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import leaves, unflatten
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

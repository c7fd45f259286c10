"""AdamW with mixed precision on one device.

Ports ``repro/train/optimizer.py``: parameters live in the config's dtype
(bfloat16, the compute dtype); the optimizer state holds float32 master
weights and first/second moments. ``adamw_update`` is a plain function under
``torch.no_grad()`` with the reference's arithmetic in its order — the clip
scale ``min(1, clip / (gnorm + 1e-9))``, the bias corrections ``1 - b**step``,
``master - lr * (update + wd * master)``, then the cast back to each
parameter's dtype — and returns new tensors (the step is functional, as the
reference's; nothing is updated in place). ``torch.optim.AdamW`` keeps no
float32 master and rounds in another order, so it is not used.

The step count and the learning rate stay on the host as Python numbers
(float32 arithmetic on numpy scalars, as the reference computes them on the
device), so a step makes no host sync; the gradient norm and the clip scale
stay on the device.

The reference's ZeRO-1 layout (``zero1_pspec``, ``opt_state_pspecs``) shards
the state over a TPU mesh axis; one device has nothing to shard.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.params import leaves, map_tree, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_frac * peak, in float32."""
    f = np.float32
    s = f(step)
    warm = f(cfg.peak_lr) * (s + f(1.0)) / f(max(cfg.warmup_steps, 1))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (
        f(1.0) + np.cos(f(np.pi) * prog))
    return float(warm if s < cfg.warmup_steps else f(cfg.peak_lr) * cos)


def init_opt_state(params) -> dict:
    """params -> {"master", "m", "v": float32 trees, "step": 0}. The master
    is always a copy (a float32 parameter never aliases it)."""
    master = map_tree(params, lambda p: p.detach().to(F32, copy=True))
    return {
        "master": master,
        "m": map_tree(master, torch.zeros_like),
        "v": map_tree(master, torch.zeros_like),
        "step": 0,
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g**2) in float32 (a device
    scalar)."""
    sq = sum(g.float().square().sum() for g in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: OptConfig):
    """One AdamW step.

    Args:
      params: parameter tree (the config's dtype).
      grads: tree of the same structure, any float dtype (used in float32).
      opt_state: from ``init_opt_state``.

    Returns (new params, new opt_state, {"grad_norm": device scalar, the
    norm before clipping; "lr": host float}).
    """
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

    def upd(master, m, v, g):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g.square()
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        master2 = master - lr * (update + cfg.weight_decay * master)
        return master2, m2, v2

    out = [upd(*t) for t in zip(leaves(opt_state["master"]),
                                leaves(opt_state["m"]),
                                leaves(opt_state["v"]), leaves(grads))]
    master2 = unflatten(opt_state["master"], [o[0] for o in out])
    new_params = unflatten(params, [o[0].to(p.dtype) for o, p in
                                    zip(out, leaves(params))])
    new_state = {"master": master2,
                 "m": unflatten(opt_state["m"], [o[1] for o in out]),
                 "v": unflatten(opt_state["v"], [o[2] for o in out]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

"""Mixture-of-Experts layer: GShard-style top-k dispatch/combine einsums.

Ports ``repro/models/moe.py``. Covers both assigned MoE architectures:
  * arctic-480b — 128 experts, top-2, plus a *dense residual* FFN computed
    in parallel with the MoE branch every layer;
  * deepseek-moe-16b — 64 routed experts top-6 plus 2 *shared* experts that
    process every token, fused into one dense SwiGLU of width n_shared *
    d_ff_expert.

Tokens route within their batch row (GShard groups) with capacity
``max(1, int(capacity_factor * top_k * S / E))``; overflow drops. The
reference has no Pallas kernel here: dispatch, experts and combine are
``torch.einsum`` (batched matmuls on the card). Two of the reference's
JAX semantics are kept by construction rather than by library call:
``jax.lax.top_k`` breaks ties toward the lower expert index
(``topk_ascending_ties``; ``torch.topk`` leaves tie order open), and
``jax.nn.one_hot`` gives a zero row for an out-of-range index, which the
capacity drop relies on (every one-hot here is a comparison; ``F.one_hot``
raises on such an index and syncs the card to check).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.reducers import topk_ascending_ties
from repro_torch.models import layers as L
from repro_torch.models.params import dense_init

F32 = torch.float32


def moe_init(cfg, generator: torch.Generator, device) -> dict:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_ff_expert
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "router": dense_init((d, e), F32, generator, device),
        "wi_gate": dense_init((e, d, f), dt, generator, device),
        "wi_up": dense_init((e, d, f), dt, generator, device),
        "wo": dense_init((e, f, d), dt, generator, device, scale=f ** -0.5),
    }
    if mo.n_shared:
        p["shared"] = L.mlp_init(cfg, generator, device,
                                 d_ff=mo.n_shared * f)
    if mo.dense_residual:
        p["dense"] = L.mlp_init(cfg, generator, device, d_ff=cfg.d_ff)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def route(p, x, cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (router probabilities (B, S, E) float32, gates (B, S,
    K) float32 normalised over the K choices, expert ids (B, S, K) int64 in
    descending probability order, ties to the lower id)."""
    b, s, _ = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    idx = topk_ascending_ties(probs.reshape(b * s, e), k,
                              largest=True).view(b, s, k)
    gates = torch.take_along_dim(probs, idx, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, idx


def moe_apply(p, x, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). x: (B, S, D)."""
    mo = cfg.moe
    b, s, d = x.shape
    e, k = mo.n_experts, mo.top_k
    cap = max(1, int(mo.capacity_factor * k * s / e))

    probs, gates, idx = route(p, x, cfg)
    onehot = _one_hot(idx, e)                                    # (B,S,K,E)
    # position of each (token, choice) in its expert's queue, in token order
    flat = onehot.reshape(b, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    pos_tok = (pos * onehot).sum(dim=-1)                         # (B,S,K)
    keep = (pos_tok < cap).to(F32)                               # capacity drop
    pos_oh = _one_hot(pos_tok.to(torch.int32), cap)

    slot_oh = pos_oh * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", onehot, slot_oh).to(x.dtype)
    combine = torch.einsum("bske,bskc->bsec", onehot * gates[..., None],
                           slot_oh).to(x.dtype)

    e_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)           # (E,B,C,D)
    g = L.silu(torch.einsum("ebcd,edf->ebcf", e_in, p["wi_gate"]))
    u = torch.einsum("ebcd,edf->ebcf", e_in, p["wi_up"])
    e_out = torch.einsum("ebcf,efd->ebcd", g * u, p["wo"])
    y = torch.einsum("ebcd,bsec->bsd", e_out, combine)

    if "shared" in p:
        y = y + L.mlp(p["shared"], x)
    if "dense" in p:
        y = y + L.mlp(p["dense"], x)

    # Switch-style load-balancing auxiliary loss
    density = onehot.mean(dim=(0, 1, 2))                         # (E,)
    mean_probs = probs.mean(dim=(0, 1))                          # (E,)
    aux = e * (density * mean_probs).sum() * mo.router_aux_weight
    return y, aux

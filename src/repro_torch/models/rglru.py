"""RG-LRU recurrent blocks (Griffin / RecurrentGemma — arXiv:2402.19427).

Ports ``repro/models/rglru.py``. Recurrent sublayer: in-proj -> causal
depthwise conv(4) -> RG-LRU -> gated merge -> out-proj:

    r_t = sigmoid(w_r . x_t + b_r)          (recurrence gate, per channel)
    i_t = sigmoid(w_i . x_t + b_i)          (input gate, per channel)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate is ``jax.nn.gelu``'s default, the tanh approximation
(``layers.gelu_tanh``, op for op; ``F.gelu`` defaults to erf). Training
and prefill (``rglru_train``) run the linear recurrence h_t = a_t h_{t-1} +
b_t over the sequence in float32 as ``jax.lax.associative_scan``'s odd/even
recursion (``_associative_scan``, O(log L) depth, no loop over L), so the
sums fall in the reference's order; decoding is the single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu_tanh
from repro_torch.models.params import dense_init, ones_init, zeros_init
from repro_torch.models.ssm import _causal_dconv, _dconv_step

F32 = torch.float32
C_MAG = 8.0


def rglru_init(cfg, generator: torch.Generator, device) -> dict:
    d = cfg.d_model
    dr = d  # lru width = d_model (RecurrentGemma-2B: 2560)
    dt = getattr(torch, cfg.param_dtype)
    # Lambda so that a ~ Uniform(0.9, 0.999) at r = 1 (paper App. A)
    u = 0.9 + 0.099 * torch.rand((dr,), generator=generator, device=device,
                                 dtype=F32)
    lam = torch.log(torch.expm1(-torch.log(u) / C_MAG))
    return {
        "w_in": dense_init((d, dr), dt, generator, device),
        "w_gate": dense_init((d, dr), dt, generator, device),
        "conv": dense_init((4, dr), dt, generator, device, scale=0.5),
        "w_r": ones_init((dr,), F32, device),
        "b_r": zeros_init((dr,), F32, device),
        "w_i": ones_init((dr,), F32, device),
        "b_i": zeros_init((dr,), F32, device),
        "lam": lam,
        "w_out": dense_init((dr, d), dt, generator, device),
    }


def _gates(p, x):
    """x: (..., dr) -> (a, gated_input) in float32."""
    xf = x.float()
    r = torch.sigmoid(xf * p["w_r"] + p["b_r"])
    i = torch.sigmoid(xf * p["w_i"] + p["b_i"])
    log_a = -C_MAG * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xf)


def _slice(t, dim: int, start, stop=None, step: int = 1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even, odd, dim: int):
    """even[0], odd[0], even[1], ... along ``dim``; ``even`` as long as
    ``odd`` or one longer."""
    n = odd.shape[dim]
    pairs = torch.stack([_slice(even, dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, _slice(even, dim, n)], dim=dim)
    return out


def _associative_scan(fn, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(earlier, later)``: ``jax.lax.associative_scan``'s
    recursion, step for step — combine adjacent pairs, scan those, then
    combine the scanned pairs with the even elements — so every element is
    combined in the reference's order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                 tuple(_slice(e, dim, 1, None, 2) for e in elems))
    odd = _associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(_slice(e, dim, 0, -1) for e in odd),
                  tuple(_slice(e, dim, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(_slice(e, dim, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _combine(c1, c2):
    """Two steps of h -> a h + b composed, the earlier first."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def rglru_train(p, x, cfg):
    """Full-sequence recurrent sublayer. x: (B, L, D) -> (B, L, D)."""
    u = _causal_dconv(x @ p["w_in"], p["conv"])
    a, bx = _gates(p, u)
    _, h = _associative_scan(_combine, (a, bx), dim=1)
    gate = gelu_tanh(x @ p["w_gate"])
    return (h.to(x.dtype) * gate) @ p["w_out"]


def rglru_init_state(cfg, batch: int, dtype, device) -> dict:
    dr = cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=F32, device=device),
        "conv": torch.zeros((batch, 3, dr), dtype=dtype, device=device),
    }


def rglru_decode(p, x1, state, cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode. x1: (B, 1, D) -> (y (B, 1, D), the new state)."""
    x = x1[:, 0, :]
    u, conv_st = _dconv_step(state["conv"], x @ p["w_in"], p["conv"])
    a, bx = _gates(p, u)
    h = a * state["h"] + bx
    gate = gelu_tanh(x @ p["w_gate"])
    y = (h.to(x1.dtype) * gate) @ p["w_out"]
    return y[:, None, :], {"h": h, "conv": conv_st}

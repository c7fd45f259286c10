"""Mamba-2 SSD (state-space duality) blocks, decode half — arXiv:2405.21060.

Ports ``ssm_init``, ``ssm_init_state``, ``_dconv_step`` and ``ssm_decode``
of ``repro/models/ssm.py``: the O(1) recurrent state update per token. The
chunked SSD scan of the training forward (``ssd_chunked``, ``ssm_train``)
comes with the training slice. The state is kept in the parameter dtype, as
the reference keeps it.

Rounding follows the reference's ``jnp.einsum`` where the order is a choice:
the three-operand product ``"bhp,bhn,bh->bhpn"`` multiplies x by dt first,
then by B (each product rounded to the activation dtype), as ``jnp.einsum``'s
contraction path does; the depthwise conv step is one float32 dot rounded
once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm, silu
from repro_torch.models.params import dense_init, ones_init, zeros_init

F32 = torch.float32


def ssm_init(cfg, generator: torch.Generator, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    dt = getattr(torch, cfg.param_dtype)

    def dense(shape, scale=None):
        return dense_init(shape, dt, generator, device, scale=scale)
    return {
        "w_z": dense((d, d_in)),
        "w_x": dense((d, d_in)),
        "w_B": dense((d, gn)),
        "w_C": dense((d, gn)),
        "w_dt": dense((d, h)),
        "conv_x": dense((s.conv_width, d_in), 0.5),
        "conv_B": dense((s.conv_width, gn), 0.5),
        "conv_C": dense((s.conv_width, gn), 0.5),
        # A in (-1, 0): A = -exp(A_log); init A in [-1, -0.5]
        "A_log": torch.log(torch.linspace(0.5, 1.0, h, dtype=F32,
                                          device=device)),
        "dt_bias": zeros_init((h,), F32, device),
        "D": ones_init((h,), F32, device),
        "norm": ones_init((d_in,), F32, device),
        "w_out": dense((d_in, d)),
    }


def ssm_init_state(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    w = s.conv_width - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "ssm": zeros(batch, h, s.head_dim, s.state_dim),
        "conv_x": zeros(batch, w, d_in),
        "conv_B": zeros(batch, w, gn),
        "conv_C": zeros(batch, w, gn),
    }


def _dconv_step(state, xnew, w):
    """One causal depthwise conv step. state: (B, W-1, C); xnew: (B, C) ->
    (y (B, C), the next state (B, W-1, C))."""
    full = torch.cat([state, xnew[:, None, :].to(state.dtype)], dim=1)
    y = torch.einsum("bwc,wc->bc", full.float(), w.float()).to(full.dtype)
    return y, full[:, 1:, :]


def ssm_decode(p, x1, state, cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode. x1: (B, 1, D); state from ssm_init_state ->
    (y (B, 1, D), the new state)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    x = x1[:, 0, :]
    z = x @ p["w_z"]
    xc, st_x = _dconv_step(state["conv_x"], x @ p["w_x"], p["conv_x"])
    bc, st_b = _dconv_step(state["conv_B"], x @ p["w_B"], p["conv_B"])
    cc, st_c = _dconv_step(state["conv_C"], x @ p["w_C"], p["conv_C"])
    xc, bc, cc = silu(xc), silu(bc), silu(cc)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])      # (B,H) f32
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a[None, :]).to(x.dtype)                  # (B,H)

    reps = h // s.n_groups
    bh = bc.reshape(-1, s.n_groups, s.state_dim).repeat_interleave(reps, 1)
    ch = cc.reshape(-1, s.n_groups, s.state_dim).repeat_interleave(reps, 1)
    xh = xc.reshape(-1, h, s.head_dim)

    xdt = xh * dt.to(x.dtype)[..., None]                         # (B,H,P)
    new_ssm = (state["ssm"] * da[..., None, None]
               + xdt[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", ch, new_ssm)
    y = y + xh * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(-1, d_in)
    y = rmsnorm(p["norm"], y * silu(z), cfg.norm_eps)
    out = y @ p["w_out"]
    new_state = {"ssm": new_ssm, "conv_x": st_x, "conv_B": st_b,
                 "conv_C": st_c}
    return out[:, None, :], new_state

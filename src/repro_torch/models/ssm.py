"""Mamba-2 SSD (state-space duality) blocks — arXiv:2405.21060.

Ports ``repro/models/ssm.py``. Training and prefill: ``ssm_train``, the
chunked SSD algorithm (``ssd_chunked``, paper §6) — an intra-chunk
quadratic, attention-like term plus an inter-chunk state recurrence, a loop
over the L / chunk chunks as the reference's ``lax.scan``. Decode:
``ssm_decode``, the O(1) recurrent state update per token. The state is
kept in the parameter dtype, as the reference keeps it.

Rounding follows the reference's ``jnp.einsum`` where the order is a choice.
Each multi-operand product is contracted pairwise in the order of
``jnp.einsum``'s contraction path (``optimize="auto"``; the same at every
shape from the tests' to Mamba-2's published widths), each pairwise result
rounded to the activation dtype:
  * the intra-chunk output: C·B over the state, then times the decay,
    then against x over the chunk;
  * the chunk-final states: the decay times x, then against B over the
    chunk;
  * the inter-chunk output: C·state over the state, then times the decay;
  * the decode update ``"bhp,bhn,bh->bhpn"``: x times dt, then times B.
The sequence form's depthwise conv (``_causal_dconv``) accumulates tap by
tap in the activation dtype, one product and one add each, as the
reference's; the decode step's (``_dconv_step``) is one float32 dot
rounded once, as its ``jnp.einsum`` is.
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


def _causal_dconv(x, w):
    """Depthwise causal 1-D conv. x: (B, L, C); w: (W, C) -> (B, L, C),
    summed tap by tap in x's dtype."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def _segsum(x):
    """(..., T) -> (..., T, T) lower-triangular segment sums (SSD decay),
    -inf above the diagonal."""
    t = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    d = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, -torch.inf)


def ssd_chunked(xh, dth, a, bh, ch, chunk: int):
    """Chunked SSD scan (Dao & Gu 2024, minimal listing).

    Args:
      xh: (B, L, H, P) inputs (the dt weighting is applied here).
      dth: (B, L, H) positive step sizes.
      a: (H,) negative continuous-time decay, float32.
      bh, ch: (B, L, H, N) input/output projections (expanded per head).
      chunk: chunk length (L % chunk == 0).

    Returns:
      (B, L, H, P) outputs and the final state (B, H, P, N), in xh's dtype.
    """
    b, l, h, p = xh.shape
    n = bh.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = l // chunk
    dtype = xh.dtype
    # (B, C, H, Lc, .) per-chunk matrices for the batched products
    xb = (xh * dth[..., None]).reshape(b, nc, chunk, h, p).transpose(2, 3)
    ab = (a[None, None, :] * dth).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    bb = bh.reshape(b, nc, chunk, h, n).transpose(2, 3)
    cb = ch.reshape(b, nc, chunk, h, n).transpose(2, 3)

    a_cs = torch.cumsum(ab, dim=-1)                   # (B,H,C,Lc) float32
    decay = torch.exp(_segsum(ab.float()))            # (B,H,C,Lc,Lc)

    # intra-chunk (quadratic within the chunk): C·B, times the decay, then
    # against x
    scores = cb @ bb.transpose(-1, -2)                # (B,C,H,Lc,Lc)
    scores = scores * decay.to(dtype).transpose(1, 2)
    y_diag = scores @ xb                              # (B,C,H,Lc,P)

    # chunk-final states: the decay times x, then against B
    decay_states = torch.exp((a_cs[..., -1:] - a_cs).float()).to(dtype)
    xd = xb * decay_states.transpose(1, 2)[..., None]  # (B,C,H,Lc,P)
    states = xd.transpose(-1, -2) @ bb                # (B,C,H,P,N)

    # inter-chunk recurrence over the chunks, as the reference's lax.scan
    chunk_decay = torch.exp(a_cs[..., -1].float()).to(dtype)   # (B,H,C)
    s = torch.zeros((b, h, p, n), dtype=dtype, device=xh.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    s_before = torch.stack(before, dim=1)             # (B,C,H,P,N)

    state_decay_out = torch.exp(a_cs.float()).to(dtype)  # (B,H,C,Lc)
    y_off = cb @ s_before.transpose(-1, -2)           # (B,C,H,Lc,P)
    y_off = y_off * state_decay_out.transpose(1, 2)[..., None]

    y = (y_diag + y_off).transpose(2, 3).reshape(b, l, h, p)
    return y, s


def ssm_train(p, x, cfg):
    """Full-sequence Mamba-2 mixer. x: (B, L, D) -> (B, L, D)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    z = x @ p["w_z"]
    xc = _causal_dconv(x @ p["w_x"], p["conv_x"])
    bc = _causal_dconv(x @ p["w_B"], p["conv_B"])
    cc = _causal_dconv(x @ p["w_C"], p["conv_C"])
    xc, bc, cc = silu(xc), silu(bc), silu(cc)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])   # (B,L,H) f32
    a = -torch.exp(p["A_log"])                                # (H,) negative

    bl, l = x.shape[0], x.shape[1]
    xh = xc.reshape(bl, l, h, s.head_dim)
    # expand groups to heads (n_groups = 1: broadcast)
    reps = h // s.n_groups
    bh = bc.reshape(bl, l, s.n_groups, s.state_dim).repeat_interleave(reps, 2)
    ch = cc.reshape(bl, l, s.n_groups, s.state_dim).repeat_interleave(reps, 2)

    y, _ = ssd_chunked(xh, dt.to(x.dtype), a, bh, ch, min(s.chunk, l))
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(bl, l, d_in)
    # gated RMSNorm, then the out-projection (the Mamba-2 block's tail)
    y = rmsnorm(p["norm"], y * silu(z), cfg.norm_eps)
    return y @ p["w_out"]


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

"""Shared layer library, decode half: RMSNorm, RoPE, GQA decode attention
with the zone-map KV block prune, SwiGLU MLP, embedding/unembed.

Ports the decode-side functions of ``repro/models/layers.py`` as plain
functions on tensors. Conventions, as in the reference:
  * a layer's parameters are a dict of tensors; weights and activations in
    the config's dtype, norm scales and softmax/norm internals in float32;
  * decode caches are full ``(B, S_slots, KV, hd)`` per layer (the ring
    cache of sliding-window attention is not ported yet); RoPE is applied at
    write time, so reads need no re-rotation.
Where the reference returns an updated cache, the port updates the cache
tensors in place (``mha_decode`` writes the new key/value and the zone maps
into the tensors it is given).

The ``kv_block_prune`` branch routes its attention through the counted op
``ops.kv_visit_attention``: the hand-written CUDA kernel on the card, its
plain version on the CPU. The reference's branch gathers the selected
blocks (``take_along_axis``) and runs ``_sdpa_pruned``; the op computes the
same function on the same visit list without copying a block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import numerics
from repro_torch.kernels import ops
from repro_torch.kernels.reducers import topk_ascending_ties
from repro_torch.models.params import dense_init, ones_init

F32 = torch.float32
# large negative for masks, dtype-derived so it stays finite after bf16 casts
NEG = numerics.mask_fill(torch.bfloat16)


def as_dtype_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (the reference multiplies by a scalar array
    of the activation dtype)."""
    return torch.tensor(x, dtype=dtype).item()


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def headwise_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Qwen3-style per-head RMS norm over head_dim; x: (..., hd)."""
    return rmsnorm(scale, x, eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved), float32 internals;
    x: (B, S, H, hd), positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attention_init(cfg, generator: torch.Generator, device) -> dict:
    """One layer's attention weights: wq (d, H, hd), wk/wv (d, KV, hd),
    wo (H, hd, d); q_norm/k_norm (hd,) float32 ones under ``qk_norm``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "wq": dense_init((d, h, hd), dt, generator, device),
        "wk": dense_init((d, kv, hd), dt, generator, device),
        "wv": dense_init((d, kv, hd), dt, generator, device),
        "wo": dense_init((h, hd, d), dt, generator, device,
                         scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones_init((hd,), F32, device)
        p["k_norm"] = ones_init((hd,), F32, device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened (h, k)."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:2], *w.shape[1:])


def _qkv(p, x, positions, cfg):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = headwise_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = headwise_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_kv: int, scores_f32: bool = True):
    """Grouped scaled-dot-product attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); mask: (B|1, Sq, Skv) bool.
    scores_f32=False keeps the score tensor in the activation dtype with a
    float32 running max / denominator.
    """
    b, sq, h, hd = q.shape
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k)
    scale = as_dtype_scalar(hd ** -0.5, scores.dtype)
    m5 = mask[:, None, None, :, :]
    if scores_f32:
        scores = scores.float() * scale
        scores = torch.where(m5, scores, NEG)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
    else:
        scores = scores * scale
        neg = torch.tensor(numerics.mask_fill(scores.dtype), dtype=scores.dtype,
                           device=scores.device)
        scores = torch.where(m5, scores, neg)
        m = scores.float().amax(dim=-1, keepdim=True)
        e = (scores.float() - m).exp().to(q.dtype)
        denom = e.float().sum(dim=-1, keepdim=True)
        w = e / denom.clamp(min=1e-30).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, sq, h, hd)


def decode_key_positions(pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Absolute position held by each slot of a full cache at decode step
    ``pos`` (B,): slot s holds position s if s <= pos, else -1 (masked)."""
    slots = torch.arange(n_slots, device=pos.device)[None, :]
    return torch.where(slots <= pos[:, None], slots, -1)


def select_blocks(ub: torch.Tensor, keep: int, groups: int) -> torch.Tensor:
    """The top-``keep`` blocks of each (B, KV) row of score upper bounds ub
    (B, KV, nb) -> (B, KV, keep') int64 block ids, in descending bound order
    with ties to the lower block id — exactly ``jax.lax.top_k``'s list
    (``torch.topk`` leaves tie order open, and -inf ties are common early in
    decode). ``groups`` > 0 selects top-(keep // groups) inside each of
    ``groups`` contiguous block groups (keep' = groups * max(1, keep //
    groups))."""
    b, kv, nb = ub.shape
    if not groups:
        return topk_ascending_ties(ub.reshape(b * kv, nb), keep,
                                   largest=True).view(b, kv, keep)
    if nb % groups:
        raise ValueError(f"blocks {nb} must divide into {groups} groups")
    nbg = nb // groups
    kg = max(1, keep // groups)
    top = topk_ascending_ties(ub.reshape(b * kv * groups, nbg), kg,
                              largest=True).view(b, kv, groups, kg)
    offs = torch.arange(groups, device=ub.device) * nbg
    return (top + offs[None, None, :, None]).reshape(b, kv, groups * kg)


def block_upper_bounds(qg: torch.Tensor, kmin: torch.Tensor,
                       kmax: torch.Tensor) -> torch.Tensor:
    """Zone-map score bound per (B, KV, block), max over the G query rows:
    sum_d max(q_d*kmin_d, q_d*kmax_d) = q+ . kmax + q- . kmin (exact).
    qg: (B, KV, G, hd) float32; kmin/kmax: (B, nb, KV, hd) float32."""
    qpos = qg.clamp(min=0.0)
    qneg = qg.clamp(max=0.0)
    return (torch.einsum("bkgh,bnkh->bkgn", qpos, kmax)
            + torch.einsum("bkgh,bnkh->bkgn", qneg, kmin)).amax(dim=2)


def mha_decode(p, x1, pos, k_cache, v_cache, cfg, *, extras=None,
               backend: str = "auto", visits: list | None = None):
    """Single-token decode with an in-place cache update.

    x1: (B, 1, D); pos: (B,) absolute positions; k_cache/v_cache:
    (B, S_slots, KV, hd), written at slot ``pos``. cfg.kv_block_prune > 0
    enables the zone-map block prune: ``extras`` holds the per-block running
    ``kmin``/``kmax`` (B, nb, KV, hd) float32 of the rope'd keys, updated
    in place; the bound q+.kmax + q-.kmin (max over each kv head's G query
    rows) ranks the blocks, blocks with no valid key rank -inf, the block
    being written +inf, and only the top ``kv_block_prune`` are read.
    ``visits``, when a list, receives (block ids, bounds) of this layer.

    Returns y1 (B, 1, D).
    """
    if cfg.kv_cache_int8:
        raise NotImplementedError("int8 KV caches are not ported yet")
    q, k, v = _qkv(p, x1, pos[:, None], cfg)
    b, n_slots, n_kv, hd = k_cache.shape
    h = cfg.n_heads
    # dynamic_update_slice semantics: the start index clamps into range
    slot = pos.long().clamp(0, n_slots - 1)
    rows = torch.arange(b, device=pos.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)

    kpos = decode_key_positions(pos, n_slots)
    mask = (kpos >= 0) & (kpos <= pos[:, None])                  # (B, S)

    if cfg.kv_block_prune:
        bs = cfg.kv_block_size
        if n_slots % bs:
            raise ValueError(f"{n_slots} cache slots are not whole blocks "
                             f"of {bs}")
        nb = n_slots // bs
        bidx = slot // bs
        kmin, kmax = extras["kmin"], extras["kmax"]
        kf = k[:, 0].to(kmin.dtype)
        kmin[rows, bidx] = torch.minimum(kmin[rows, bidx], kf)
        kmax[rows, bidx] = torch.maximum(kmax[rows, bidx], kf)

        keep = min(cfg.kv_block_prune, nb)
        qg = q[:, 0].reshape(b, n_kv, h // n_kv, hd)
        ub = block_upper_bounds(qg.float(), kmin.float(), kmax.float())
        blk_valid = mask.view(b, nb, bs).any(dim=-1)             # (B, nb)
        ub = torch.where(blk_valid[:, None, :], ub, float("-inf"))
        # (a comparison, not F.one_hot: that one checks its indices with a
        # host sync on the card)
        cur = torch.arange(nb, device=bidx.device)[None, :] == bidx[:, None]
        ub = torch.where(cur[:, None, :], float("inf"), ub)
        top = select_blocks(ub, keep, cfg.kv_prune_groups)
        if visits is not None:
            visits.append((top, ub))

        def blocks(cache):  # block-major view of the token-major cache
            return cache.view(b, nb, bs, n_kv, hd).permute(0, 3, 1, 2, 4)

        out = ops.kv_visit_attention(qg, blocks(k_cache), blocks(v_cache),
                                     top, pos, backend=backend)
        out = out.reshape(b, 1, h, hd)
    else:
        out = _sdpa(q, k_cache, v_cache, mask[:, None, :], n_kv,
                    cfg.attn_scores_f32)
    return _proj_out(out, p["wo"])


def _proj_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_init(cfg, generator: torch.Generator, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wi_gate": dense_init((d, f), dt, generator, device),
        "wi_up": dense_init((d, f), dt, generator, device),
        "wo": dense_init((f, d), dt, generator, device),
    }


def mlp(p, x):
    g = F.silu(x @ p["wi_gate"])
    u = x @ p["wi_up"]
    return (g * u) @ p["wo"]


# --------------------------------------------------------------------------
# embedding / unembed
# --------------------------------------------------------------------------
def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def embedding_init(cfg, vocab_pad: int, generator: torch.Generator,
                   device) -> dict:
    dt = getattr(torch, cfg.param_dtype)
    # Gemma-style scaling: table std d^-1/2, embedding output times sqrt(d).
    p = {"table": dense_init((vocab_pad, cfg.d_model), dt, generator, device,
                             scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, vocab_pad), dt, generator,
                                  device)
    return p


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["table"][tokens.long()]
    return x * as_dtype_scalar(x.shape[-1] ** 0.5, x.dtype)


def unembed(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return (x @ p["table"].T).float()
    return (x @ p["unembed"]).float()

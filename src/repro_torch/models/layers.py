"""Shared layer library: RMSNorm, RoPE, GQA attention (decode with full, ring
and int8 caches and the zone-map KV block prune; the full-sequence
self-attention of the encoder and of the training forward; cross-attention),
SwiGLU MLP, embedding/unembed and the training loss.

Ports the functions of ``repro/models/layers.py`` that decode serving and
the dense training forward run, as plain functions on tensors. Conventions, as in the reference:
  * a layer's parameters are a dict of tensors; weights and activations in
    the config's dtype, norm scales and softmax/norm internals in float32;
  * decode caches are full ``(B, S_slots, KV, hd)`` per layer, or ring
    buffers of ``window`` slots for sliding-window / local attention; RoPE
    is applied at write time with absolute positions, so reads need no
    re-rotation;
  * an int8 cache holds codes and per-(token, head) float32 scales
    (``quantize_kv``), dequantized in the activation dtype where read.
Where the reference returns an updated cache, the port updates the cache
tensors in place (``mha_decode`` writes the new key/value, the scales and the
zone maps into the tensors it is given).

The ``kv_block_prune`` branch routes its attention through the counted op
``ops.kv_visit_attention``: the hand-written CUDA kernel on the card, its
plain version on the CPU. The reference's branch gathers the selected
blocks (``take_along_axis``), dequantizes them when the cache is int8, and
runs ``_sdpa_pruned``; the op computes the same function on the same visit
list without copying a block, and takes an int8 cache's scales itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
# activations, op for op as the reference's jax.nn functions: each op rounds
# to x's dtype (F.silu and F.gelu round once, which in bfloat16 gives
# another value for a third of the inputs)
# --------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * (1 / (1 + exp(-x)))."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default tanh approximation: x * (0.5 * (1 +
    tanh(sqrt(2 / pi) * (x + 0.044715 * x^3)))), the constants rounded to
    x's dtype."""
    c = as_dtype_scalar(0.044715, x.dtype)
    k = as_dtype_scalar((2 / torch.pi) ** 0.5, x.dtype)
    return x * (0.5 * (1 + torch.tanh(k * (x + c * (x * x * x)))))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> torch.Tensor:
    return ones_init((d,), F32, device)


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
def attention_init(cfg, generator: torch.Generator, device,
                   cross: bool = False) -> dict:
    """One layer's attention weights: wq (d, H, hd), wk/wv (d, KV, hd),
    wo (H, hd, d); q_norm/k_norm (hd,) float32 ones under ``qk_norm``
    (not for cross-attention)."""
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
    if cfg.qk_norm and not cross:
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


def _train_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Skv) mask from absolute positions."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


def mha_train(p, x, positions, cfg, *, causal: bool = True,
              window: Optional[int] = None,
              q_chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self-attention (the encoder's; the training slice's
    decoder layers reuse it); query-chunked when S > q_chunk, as the
    reference (whose mesh constraints have no one-device counterpart)."""
    q_chunk = q_chunk or cfg.q_chunk
    q, k, v = _qkv(p, x, positions, cfg)
    b, s = x.shape[:2]
    if s <= q_chunk:
        mask = _train_mask(positions, positions, causal, window)
        out = _sdpa(q, k, v, mask, cfg.n_kv_heads, cfg.attn_scores_f32)
    else:
        if s % q_chunk:
            raise ValueError(f"sequence {s} is not whole chunks of {q_chunk}")
        out = torch.cat([
            _sdpa(q[:, i:i + q_chunk], k, v,
                  _train_mask(positions[:, i:i + q_chunk], positions, causal,
                              window),
                  cfg.n_kv_heads, cfg.attn_scores_f32)
            for i in range(0, s, q_chunk)], dim=1)
    return _proj_out(out, p["wo"])


# -- decode -----------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Per-layer-stacked KV cache. ``window`` => ring buffer semantics."""
    k: torch.Tensor  # (L, B, S_slots, KV, hd)
    v: torch.Tensor
    window: Optional[int] = None


def _ring_slot(pos: torch.Tensor, window: int) -> torch.Tensor:
    return torch.remainder(pos, window)


def decode_key_positions(pos: torch.Tensor, n_slots: int,
                         window: Optional[int] = None) -> torch.Tensor:
    """Absolute position held by each cache slot at decode step ``pos``.

    pos: (B,) int — position of the token being decoded (0-based); slots
    holding nothing yet get position -1 (masked).
    Full cache: slot s holds position s if s <= pos.
    Ring cache: slot s holds the latest position p <= pos with p % window == s.
    """
    slots = torch.arange(n_slots, device=pos.device)[None, :]
    if window is None:
        return torch.where(slots <= pos[:, None], slots, -1)
    w = torch.remainder(pos[:, None], window)
    kpos = pos[:, None] - torch.remainder(w - slots, window)
    return torch.where(kpos < 0, -1, kpos)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, KV, hd) -> (int8 codes, per-(token, head) float32 scale
    (B, 1, KV, 1)): amax / 127 (at least 1e-12), codes rounded half to even
    and clipped to [-127, 127] — bit for bit the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


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


def mha_decode(p, x1, pos, k_cache, v_cache, cfg, *,
               window: Optional[int] = None, extras: Optional[dict] = None,
               backend: str = "auto", visits: list | None = None):
    """Single-token decode with an in-place cache update.

    x1: (B, 1, D); pos: (B,) absolute positions; k_cache/v_cache:
    (B, S_slots, KV, hd), written at slot ``pos`` (``pos % window`` for a
    ring cache of ``window`` slots) — int8 under ``cfg.kv_cache_int8``,
    with the per-token scales ``extras["k_scale"]``/``["v_scale"]`` (B,
    S_slots, KV, 1) float32 written beside them. cfg.kv_block_prune > 0
    enables the zone-map block prune (full caches only, as the reference
    asserts): ``extras`` holds the per-block running ``kmin``/``kmax`` (B,
    nb, KV, hd) float32 of the rope'd keys, updated in place; the bound
    q+.kmax + q-.kmin (max over each kv head's G query rows) ranks the
    blocks, blocks with no valid key rank -inf, the block being written
    +inf, and only the top ``kv_block_prune`` are read. ``visits``, when a
    list, receives (block ids, bounds) of this layer.

    Returns y1 (B, 1, D).
    """
    if cfg.kv_block_prune and window is not None:
        raise ValueError("block pruning targets full caches: a windowed "
                         "(ring) cache cannot be pruned")
    q, k, v = _qkv(p, x1, pos[:, None], cfg)
    b, n_slots, n_kv, hd = k_cache.shape
    h = cfg.n_heads
    slot = pos if window is None else _ring_slot(pos, window)
    # dynamic_update_slice semantics: the start index clamps into range
    slot = slot.long().clamp(0, n_slots - 1)
    rows = torch.arange(b, device=pos.device)
    if cfg.kv_cache_int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[rows, slot] = kq[:, 0]
        v_cache[rows, slot] = vq[:, 0]
        extras["k_scale"][rows, slot] = ks[:, 0]
        extras["v_scale"][rows, slot] = vs[:, 0]
    else:
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)

    kpos = decode_key_positions(pos, n_slots, window)
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
            return cache.view(b, nb, bs, n_kv, -1).permute(0, 3, 1, 2, 4)

        scales = {}
        if cfg.kv_cache_int8:
            scales = {"k_scale": blocks(extras["k_scale"]),
                      "v_scale": blocks(extras["v_scale"])}
        out = ops.kv_visit_attention(qg, blocks(k_cache), blocks(v_cache),
                                     top, pos, **scales, backend=backend)
        out = out.reshape(b, 1, h, hd)
    else:
        if cfg.kv_cache_int8:
            kf = k_cache.to(x1.dtype) * extras["k_scale"].to(x1.dtype)
            vf = v_cache.to(x1.dtype) * extras["v_scale"].to(x1.dtype)
        else:
            kf, vf = k_cache, v_cache
        out = _sdpa(q, kf, vf, mask[:, None, :], n_kv, cfg.attn_scores_f32)
    return _proj_out(out, p["wo"])


# -- cross-attention (encoder-decoder) ---------------------------------------
def cross_kv(p, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V (B, S_enc, KV, hd) from the encoder output (cached for
    decode)."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def cross_attend(p, x, k, v, cfg, enc_mask=None) -> torch.Tensor:
    """Cross-attention: no RoPE, no causality; enc_mask: (B, S_enc) or
    None."""
    q = _proj(x, p["wq"])
    b, sq = x.shape[:2]
    skv = k.shape[1]
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=x.device) \
        if enc_mask is None else enc_mask[:, None, :].expand(b, sq, skv)
    out = _sdpa(q, k, v, mask, cfg.n_kv_heads)
    return _proj_out(out, p["wo"])


def _proj_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_init(cfg, generator: torch.Generator, device,
             d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wi_gate": dense_init((d, f), dt, generator, device),
        "wi_up": dense_init((d, f), dt, generator, device),
        "wo": dense_init((f, d), dt, generator, device),
    }


def mlp(p, x):
    g = silu(x @ p["wi_gate"])
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


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy in float32 over every label position;
    logits may be vocab-padded (labels < vocab_size).

    Padded vocabulary columns are filled with ``NEG`` (finite, dtype-derived)
    so they carry no probability mass, as in the reference.
    """
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab_ids < vocab_size, logits, NEG)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()

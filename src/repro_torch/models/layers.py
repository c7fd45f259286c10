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
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import numerics
from repro_torch.kernels import ops
from repro_torch.kernels.reducers import topk_ascending_ties
from repro_torch.models import shardctx
from repro_torch.models.params import P, dense_init, ones_init

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


def _proj(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened (h, k);
    ``mesh``, the ``shardctx`` mesh, lays the product out under one."""
    w2 = w.reshape(w.shape[0], -1)
    y = x @ w2
    if mesh is not None:
        y = shardctx.matmul_out(y, x, w2)
    return y.view(*x.shape[:2], *w.shape[1:])


def _qkv(p, x, positions, cfg, mesh):
    q = _proj(x, p["wq"], mesh)
    k = _proj(x, p["wk"], mesh)
    v = _proj(x, p["wv"], mesh)
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
    float32 running max / denominator. DTensors go to ``_sdpa_sharded``.
    """
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, mask, n_kv, scores_f32)
    return _grouped_attention(q, k, v, mask, n_kv, scores_f32)


def _grouped_attention(q, k, v, mask, n_kv: int, scores_f32: bool):
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


def _local_heads(q, k, v, mask, n_kv: int):
    """How each rank attends on its own shards of DTensors q, k, v and
    mask (``_sdpa``'s shapes): (k's and v's gradient placements, first kv
    head and kv head count of this rank's slice of its local k and v), or
    None. Each mesh dim must split the batch of all four, or none of
    them, or the query heads, with k and v split on their heads too (the
    same group on every rank) or replicated (then sliced to the kv heads
    of this rank's query heads, their gradient a partial sum)."""
    mesh, h = q.device_mesh, q.shape[2]
    g = h // n_kv
    grads, kv0, nk = [], 0, n_kv
    for i, pls in enumerate(zip(q.placements, k.placements, v.placements,
                                mask.placements)):
        pq, pk, pv, pm = pls
        if all(p == pq for p in pls) and pq in (Shard(0), Replicate()):
            grads.append(pk)
            continue
        n = mesh.size(i)
        if not (pq == Shard(2) and pk == pv and pm == Replicate()
                and h % n == 0 and nk == n_kv):
            return None
        h_l = h // n
        if pk == Shard(2) and n_kv % n == 0:
            grads.append(pk)
            nk = n_kv // n
        elif pk == Replicate() and (h_l % g == 0 or g % h_l == 0):
            grads.append(Partial())
            kv0 = mesh.get_local_rank(i) * h_l // g
            nk = max(1, h_l // g)
        else:
            return None
    return grads, kv0, nk


def _sdpa_sharded(q, k, v, mask, n_kv: int, scores_f32: bool):
    """``_sdpa`` of DTensors. Where ``_local_heads`` finds a layout, each
    rank attends on its own shards (its batch rows, its query heads and
    their kv heads), as XLA partitions the reference's grouped products,
    and the output is laid out as q. Otherwise (a decode cache whose slots
    are split over `model`) split heads are gathered, since the grouped
    products flatten (batch, kv head, group), which DTensor (torch 2.11)
    refuses with a dim after the first split, and DTensor places each
    product (a decode query is one token)."""
    how = _local_heads(q, k, v, mask, n_kv)
    if how is None:
        q, k, v = (shardctx.replicate_dim(t, 2) for t in (q, k, v))
        out = _grouped_attention(q, k, v, mask, n_kv, scores_f32)
        return shardctx.replicate_dim(out, 2)
    grads, kv0, nk = how
    kl = k.to_local(grad_placements=grads)[:, :, kv0:kv0 + nk]
    vl = v.to_local(grad_placements=grads)[:, :, kv0:kv0 + nk]
    out = _grouped_attention(q.to_local(grad_placements=q.placements), kl,
                             vl, mask.to_local(), nk, scores_f32)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _train_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Skv) mask from absolute positions."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones_like(d, dtype=torch.bool)
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
    reference.

    ``cfg.attn_batch_shard`` (policy-C archs): under a mesh, reshard the
    batch over (data..., model) around the attention so replicated-head
    compute splits over the full mesh instead of the data axis only (a
    no-op without a mesh)."""
    q_chunk = q_chunk or cfg.q_chunk
    mesh = shardctx.mesh()
    shard2d = False
    if mesh is not None and cfg.attn_batch_shard:
        bm = shardctx.batch_model_axes()
        shard2d = x.shape[0] % shardctx.axes_size(bm) == 0
    if shard2d:
        x = shardctx.constrain(x, P(bm, None, None))
        positions = shardctx.constrain(positions, P(bm, None))
    q, k, v = _qkv(p, x, positions, cfg, mesh)
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
    y = _proj_out(out, p["wo"], mesh)
    if shard2d:
        y = shardctx.constrain(y, P(shardctx.batch_axes(), None, None))
    return y


# -- decode -----------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Per-layer-stacked KV cache. ``window`` => ring buffer semantics."""
    k: torch.Tensor  # (L, B, S_slots, KV, hd)
    v: torch.Tensor
    window: Optional[int] = None


def _ring_slot(pos: torch.Tensor, window: int) -> torch.Tensor:
    return torch.remainder(pos, window)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[rows, slot] = new`` in place under a mesh; cache (B, S,
    ...), new (B, ...). The batch and the slots are split over ranks, and
    each rank selects the new row into its own shard where the slot falls
    (how XLA's SPMD partitioner splits the reference's
    dynamic_update_slice on a sharded dim): the whole shard is rewritten."""
    hit = torch.arange(cache.shape[1], device=slot.device) == slot[:, None]
    hit = hit.view(*hit.shape, *([1] * (cache.dim() - 2)))
    # an in-place write of each rank's own shard, no copy between devices
    cache.copy_(torch.where(hit, new[:, None], cache))  # mdrqlint: disable=raw-shard-map


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
    mesh = shardctx.mesh()
    if cfg.kv_block_prune and mesh is not None:
        raise NotImplementedError(
            "kv_block_prune under a mesh (the kv_visit wrapper on DTensors) "
            "is ROADMAP queue 1, item 5b")
    q, k, v = _qkv(p, x1, pos[:, None], cfg, mesh)
    b, n_slots, n_kv, hd = k_cache.shape
    h = cfg.n_heads
    slot = pos if window is None else _ring_slot(pos, window)
    # dynamic_update_slice semantics: the start index clamps into range
    slot = slot.long().clamp(0, n_slots - 1)
    rows = torch.arange(b, device=pos.device)
    if cfg.kv_cache_int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        writes = [(k_cache, kq[:, 0]), (v_cache, vq[:, 0]),
                  (extras["k_scale"], ks[:, 0]),
                  (extras["v_scale"], vs[:, 0])]
    else:
        writes = [(k_cache, k[:, 0].to(k_cache.dtype)),
                  (v_cache, v[:, 0].to(v_cache.dtype))]
    for cache, new in writes:
        if mesh is None:
            cache[rows, slot] = new
        else:
            _write_slot(cache, slot, new)

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
    return _proj_out(out, p["wo"], mesh)


# -- cross-attention (encoder-decoder) ---------------------------------------
def cross_kv(p, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V (B, S_enc, KV, hd) from the encoder output (cached for
    decode)."""
    mesh = shardctx.mesh()
    return _proj(enc_out, p["wk"], mesh), _proj(enc_out, p["wv"], mesh)


def cross_attend(p, x, k, v, cfg, enc_mask=None) -> torch.Tensor:
    """Cross-attention: no RoPE, no causality; enc_mask: (B, S_enc) or
    None."""
    mesh = shardctx.mesh()
    q = _proj(x, p["wq"], mesh)
    b, sq = x.shape[:2]
    skv = k.shape[1]
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=x.device) \
        if enc_mask is None else enc_mask[:, None, :].expand(b, sq, skv)
    out = _sdpa(q, k, v, mask, cfg.n_kv_heads)
    return _proj_out(out, p["wo"], mesh)


def _proj_out(out: torch.Tensor, wo: torch.Tensor, mesh) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul (laid out under ``mesh`` as
    ``_proj``)."""
    b, s = out.shape[:2]
    o2, w2 = out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1])
    y = o2 @ w2
    return y if mesh is None else shardctx.matmul_out(y, o2, w2)


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
    if shardctx.mesh() is None:
        x = p["table"][tokens.long()]
    else:
        x = _embed_vocab_parallel(p["table"], tokens)
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

    Under a mesh the logits are a DTensor and the loss is
    ``_xent_vocab_parallel``'s: the log-sum-exp and the gold logit below
    would gather the whole vocabulary onto every rank.
    """
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab_ids < vocab_size, logits, NEG)
    if shardctx.mesh() is not None:
        return _xent_vocab_parallel(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


class _VocabParallelEmbed(torch.autograd.Function):
    """Rows of ``tokens`` from this rank's vocabulary slice (V_local, D) of
    the table, whose rows start at ``start``; a token outside the slice
    reads zeros, and a SUM over ``group`` (the slices) gives every rank the
    row. The gradient goes to the slice's rows of this rank's tokens."""

    @staticmethod
    def forward(ctx, table, tokens, start: int, group):
        local = tokens - start
        inside = (local >= 0) & (local < table.shape[0])
        idx = torch.where(inside, local, 0)
        rows = table[idx] * inside[..., None].to(table.dtype)
        ctx.save_for_backward(idx, inside)
        ctx.v_local = table.shape[0]
        return funcol.wait_tensor(funcol.all_reduce(rows, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        idx, inside = ctx.saved_tensors
        g = grad * inside[..., None].to(grad.dtype)
        out = grad.new_zeros((ctx.v_local, grad.shape[-1]))
        out.index_put_((idx,), g, accumulate=True)
        return out, None, None, None


def _embed_vocab_parallel(table: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` of a DTensor table under the ``shardctx`` mesh:
    the table's vocabulary split over `model`, the tokens laid out as they
    come (gathered over `model` if split there); each rank looks its tokens
    up in its slice and the slices are summed (``_VocabParallelEmbed``).
    The rows are laid out as the tokens, and the table's gradient is a
    partial sum over the mesh dims that split the tokens. (Indexing would
    gather the whole table, and DTensor's own vocabulary-parallel embedding
    fails in the backward pass under torch 2.11.)"""
    mesh = shardctx.mesh()
    table = shardctx.constrain(table, P("model", None))
    model = mesh.mesh_dim_names.index("model")
    if tokens.placements[model] != Replicate():
        tokens = tokens.redistribute(mesh, [
            Replicate() if i == model else p
            for i, p in enumerate(tokens.placements)])
    local = table.to_local(grad_placements=[
        Partial() if pt.is_shard() else p
        for p, pt in zip(table.placements, tokens.placements)])
    start = mesh.get_local_rank("model") * local.shape[0]
    out = _VocabParallelEmbed.apply(local, tokens.to_local().long(), start,
                                    mesh.get_group("model"))
    return DTensor.from_local(out, mesh, tokens.placements, run_check=False)


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross-entropy of this rank's vocabulary slice (N, V_local)
    float32 of logits whose columns start at ``start``, reduced over the
    ranks of ``group`` (the slices of one row): the row max and the sum
    of exponentials by all-reduces (MAX, SUM), the gold logit by a SUM of
    the one rank that holds it. The gradient, softmax minus the one-hot,
    is local."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, group):
        v_local = logits.shape[1]
        m = funcol.all_reduce(logits.amax(dim=-1), "max", group)
        e = (logits - m[:, None]).exp()
        z = funcol.all_reduce(e.sum(dim=-1), "sum", group)
        local = labels - start
        inside = (local >= 0) & (local < v_local)
        col = torch.where(inside, local, 0)
        gold = torch.where(inside, logits.gather(1, col[:, None])[:, 0], 0.0)
        gold = funcol.all_reduce(gold, "sum", group)
        ctx.save_for_backward(e / z[:, None], col, inside)
        return z.log() + m - gold

    @staticmethod
    def backward(ctx, grad):
        p, col, inside = ctx.saved_tensors
        onehot = torch.zeros_like(p).scatter_(1, col[:, None],
                                              inside[:, None].to(p.dtype))
        return (p - onehot) * grad[:, None], None, None, None


def _xent_vocab_parallel(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of DTensor logits (B, S, V) under the
    ``shardctx`` mesh: the logits laid out with the batch over the data
    axes and the vocabulary over `model`, each rank's per-token losses by
    ``_VocabParallelXent`` (all-reduces of one value per token, never the
    vocabulary), their sum a partial over the data axes, all-reduced."""
    mesh, ba = shardctx.mesh(), shardctx.batch_axes()
    logits = shardctx.constrain(
        logits, P(ba, *([None] * (logits.dim() - 2)), "model"))
    labels = shardctx.constrain(labels, P(ba, *([None] * (labels.dim() - 1))))
    local = logits.to_local()
    start = mesh.get_local_rank("model") * local.shape[-1]
    tok = _VocabParallelXent.apply(local.flatten(0, -2),
                                   labels.to_local().long().flatten(), start,
                                   mesh.get_group("model"))
    names = mesh.mesh_dim_names
    total = DTensor.from_local(
        tok.sum(), mesh, [Partial() if a in ba else Replicate()
                          for a in names], run_check=False)
    return total.redistribute(mesh, [Replicate()] * len(names)) \
        / labels.numel()

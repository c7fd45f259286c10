"""Decoder-only LM, dense family, decode-serving half.

Ports ``DecoderLM`` of ``repro/models/transformer.py`` for ``family ==
"dense"`` with a full (non-windowed) cache: ``init``, ``init_cache``,
``decode_step`` and ``vocab_padded``. The reference scans a stacked layer
tree; here the layers are a Python list of per-layer parameter dicts and the
loop is a Python loop (PyTorch runs eagerly). The cache keeps the
reference's stacked layout, ``k``/``v`` (L, B, S, KV, hd) and, under
``kv_block_prune``, the zone maps ``kmin``/``kmax`` (L, B, nb, KV, hd)
float32 — and ``decode_step`` updates it in place.

Not ported yet (``registry.build_model`` refuses them): the other families,
sliding-window ring caches, int8 KV, modality prefixes, and the
``forward``/``loss_fn``/``prefill`` entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import numerics
from repro_torch.models import layers as L
from repro_torch.models.params import ones_init

F32 = torch.float32
VOCAB_MULT = 256  # pad vocab to a multiple of this, as the reference does


def vocab_padded(cfg) -> int:
    return L.round_up(cfg.vocab_size, VOCAB_MULT)


def dense_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {
        "ln1": ones_init((cfg.d_model,), F32, device),
        "attn": L.attention_init(cfg, generator, device),
        "ln2": ones_init((cfg.d_model,), F32, device),
        "mlp": L.mlp_init(cfg, generator, device),
    }


@dataclasses.dataclass(frozen=True)
class DecoderLM:
    """Dense decoder-only LM on one device.

    ``backend`` is handed to the counted ops: ``"auto"`` follows the tensors'
    device (the CUDA kernel on the card, the plain version on the CPU),
    ``"torch"`` runs the plain versions anywhere.
    """

    cfg: Any
    device: torch.device
    backend: str = "auto"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.param_dtype)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator`` (on ``self.device``):
        the embedding table, the unembedding, then each layer's wq, wk, wv,
        wo, wi_gate, wi_up, wo in order."""
        cfg = self.cfg
        return {
            "embed": L.embedding_init(cfg, vocab_padded(cfg), generator,
                                      self.device),
            "final_ln": ones_init((cfg.d_model,), F32, self.device),
            "layers": [dense_layer_init(cfg, generator, self.device)
                       for _ in range(cfg.n_layers)],
        }

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, slots: int, dtype=None) -> dict:
        cfg = self.cfg
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        dt = self.dtype if dtype is None else dtype
        shape = (cfg.n_layers, batch, slots, kv, hd)
        cache = {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=self.device),
        }
        if cfg.kv_block_prune:
            nb = slots // cfg.kv_block_size
            # zone-map "+infinity": dtype-derived so it survives bf16 casts
            big = numerics.finite_max(torch.bfloat16)
            zshape = (cfg.n_layers, batch, nb, kv, hd)
            cache["kmin"] = torch.full(zshape, big, dtype=F32, device=self.device)
            cache["kmax"] = torch.full(zshape, -big, dtype=F32,
                                       device=self.device)
        return cache

    def decode_step(self, params, cache, tokens, pos, *,
                    visits: list | None = None):
        """tokens: (B, 1) int; pos: (B,) absolute positions -> (logits (B, 1,
        vocab_pad) float32, cache). The cache is updated in place and its
        ``pos`` set to ``pos + 1``. ``visits``, when a list, receives each
        layer's (block ids, bounds) under ``kv_block_prune``."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        prune = bool(cfg.kv_block_prune)
        for i, lp in enumerate(params["layers"]):
            xn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            extras = ({"kmin": cache["kmin"][i], "kmax": cache["kmax"][i]}
                      if prune else None)
            x = x + L.mha_decode(lp["attn"], xn, pos, cache["k"][i],
                                 cache["v"][i], cfg, extras=extras,
                                 backend=self.backend, visits=visits)
            x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
        cache["pos"] = pos + 1
        return logits, cache

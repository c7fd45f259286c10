"""Encoder-decoder backbone (seamless-m4t-large-v2).

Ports ``EncDecLM`` of ``repro/models/encdec.py``: ``init``, ``encode``,
``forward``, ``loss_fn``, ``prefill``, ``init_cache``, ``fill_cross_cache``
and ``decode_step``. The audio frontend is a stub, as in the reference: the
caller supplies precomputed frame embeddings (B, S_enc, D) for the
bidirectional encoder (``batch["enc_embeds"]`` in training). The decoder is
causal self-attention, cross-attention over per-layer K/V of the encoder
output (computed once per layer; in decode, once into the cache), and a
SwiGLU MLP. The layers are Python lists of per-layer parameter dicts; with
``cfg.remat != "none"`` and grad enabled each encoder and decoder layer
runs under ``torch.utils.checkpoint`` (the reference's ``_maybe_remat``),
so serving, which runs without grad, is unchanged. The cache keeps the
reference's stacked layout — ``k``/``v`` (L, B, slots, KV, hd),
``xk``/``xv`` (L, B, S_enc, KV, hd) — and ``decode_step`` updates it in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import (dense_layer_init, remat_enabled,
                                            run_layers, vocab_padded)

F32 = torch.float32


def enc_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return dense_layer_init(cfg, generator, device)


def dec_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(cfg, generator, device),
        "lnx": L.rmsnorm_init(cfg.d_model, device),
        "xattn": L.attention_init(cfg, generator, device, cross=True),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(cfg, generator, device),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    """Positions 0..S-1 of a (B, S, D) sequence, (B, S) int32."""
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=F32, device=x.device)


@dataclasses.dataclass(frozen=True)
class EncDecLM:
    """Encoder-decoder LM on one device (``backend`` as ``DecoderLM``'s; the
    decoder's full-cache attention reaches no kernel)."""

    cfg: Any
    device: torch.device
    backend: str = "auto"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.param_dtype)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator``: the encoder layers,
        the decoder layers, then the embedding."""
        cfg, dev = self.cfg, self.device
        enc = [enc_layer_init(cfg, generator, dev)
               for _ in range(cfg.encoder_layers)]
        dec = [dec_layer_init(cfg, generator, dev)
               for _ in range(cfg.n_layers)]
        return {
            "embed": L.embedding_init(cfg, vocab_padded(cfg), generator, dev),
            "enc_layers": enc,
            "enc_ln": L.rmsnorm_init(cfg.d_model, dev),
            "dec_layers": dec,
            "final_ln": L.rmsnorm_init(cfg.d_model, dev),
        }

    def encode(self, params, enc_embeds: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, D) frame embeddings -> (B, S_enc, D) encoder output."""
        cfg = self.cfg
        x = enc_embeds.to(self.dtype)
        pos = _positions(x)

        def body(lp, x):
            x = x + L.mha_train(lp["attn"],
                                L.rmsnorm(lp["ln1"], x, cfg.norm_eps), pos,
                                cfg, causal=False)
            x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
            return x, _zero(x)

        x, _ = run_layers(params["enc_layers"], x, body, remat_enabled(cfg))
        return L.rmsnorm(params["enc_ln"], x, cfg.norm_eps)

    def forward(self, params, batch):
        """``enc_embeds`` (B, S_enc, D) and ``tokens`` (B, S) -> ((B, S,
        vocab_pad) float32 logits, aux = 0)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["enc_embeds"])
        y = L.embed(params["embed"], batch["tokens"])
        pos = _positions(y)

        def body(lp, y):
            y = y + L.mha_train(lp["attn"],
                                L.rmsnorm(lp["ln1"], y, cfg.norm_eps), pos,
                                cfg, causal=True)
            xk, xv = L.cross_kv(lp["xattn"], enc_out)
            y = y + L.cross_attend(lp["xattn"],
                                   L.rmsnorm(lp["lnx"], y, cfg.norm_eps),
                                   xk, xv, cfg)
            y = y + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], y, cfg.norm_eps))
            return y, _zero(y)

        y, aux = run_layers(params["dec_layers"], y, body, remat_enabled(cfg))
        y = L.rmsnorm(params["final_ln"], y, cfg.norm_eps)
        return L.unembed(params["embed"], y, cfg.tie_embeddings), aux

    def loss_fn(self, params, batch):
        """-> (total loss, {"loss", "aux_loss"})."""
        logits, aux = self.forward(params, batch)
        loss = L.xent_loss(logits, batch["labels"], self.cfg.vocab_size)
        return loss + aux, {"loss": loss, "aux_loss": aux}

    def prefill(self, params, batch):
        """The last position of ``forward`` -> (logits (B, 1, vocab_pad)
        float32, aux)."""
        logits, aux = self.forward(params, batch)
        return logits[:, -1:, :], aux

    def init_cache(self, batch: int, slots: int, dtype=None,
                   enc_len: int = 0) -> dict:
        cfg, dev = self.cfg, self.device
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        dt = self.dtype if dtype is None else dtype
        enc_len = enc_len or max(1, slots // 4)

        def zeros(s):
            return torch.zeros((cfg.n_layers, batch, s, kv, hd), dtype=dt,
                               device=dev)
        return {"k": zeros(slots), "v": zeros(slots), "xk": zeros(enc_len),
                "xv": zeros(enc_len),
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def fill_cross_cache(self, params, cache: dict,
                         enc_embeds: torch.Tensor) -> dict:
        """Encode once; each decoder layer's cross K/V of the encoder output
        into the cache (``xk``/``xv`` take the encoder output's length, as
        the reference's do). Returns the cache."""
        enc_out = self.encode(params, enc_embeds)
        kvs = [L.cross_kv(lp["xattn"], enc_out) for lp in params["dec_layers"]]
        for i, name in enumerate(("xk", "xv")):
            dtype = cache[name].dtype
            new = torch.stack([kv[i] for kv in kvs]).to(dtype)
            if new.shape == cache[name].shape:
                cache[name][:] = new
            else:
                cache[name] = new
        return cache

    def decode_step(self, params, cache, tokens, pos, *,
                    visits: list | None = None):
        """tokens: (B, 1) int; pos: (B,) -> (logits (B, 1, vocab_pad)
        float32, cache), the cache updated in place and its ``pos`` set to
        ``pos + 1``. (``visits`` is taken for ``DecoderLM``'s signature: the
        decoder is not pruned.)"""
        cfg = self.cfg
        y = L.embed(params["embed"], tokens)
        for i, lp in enumerate(params["dec_layers"]):
            yn = L.rmsnorm(lp["ln1"], y, cfg.norm_eps)
            y = y + L.mha_decode(lp["attn"], yn, pos, cache["k"][i],
                                 cache["v"][i], cfg, backend=self.backend)
            y = y + L.cross_attend(lp["xattn"],
                                   L.rmsnorm(lp["lnx"], y, cfg.norm_eps),
                                   cache["xk"][i], cache["xv"][i], cfg)
            y = y + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], y, cfg.norm_eps))
        y = L.rmsnorm(params["final_ln"], y, cfg.norm_eps)
        logits = L.unembed(params["embed"], y, cfg.tie_embeddings)
        cache["pos"] = pos + 1
        return logits, cache

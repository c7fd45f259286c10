"""Decoder-only LM for the dense / moe / ssm / hybrid / vlm / audio
(decoder-only) families: decode serving and the training forward for every
family.

Ports ``DecoderLM`` of ``repro/models/transformer.py``: ``init``,
``init_cache``, ``decode_step`` and ``vocab_padded``, with the reference's
per-layer blocks, and ``forward``/``loss_fn``/``prefill`` (the MoE layers'
load-balancing losses summed over the stack into ``aux``). The reference
scans a stacked layer tree; here the layers are a Python list of per-layer
parameter dicts and the loop is a Python loop (PyTorch runs eagerly).
Hybrid (Griffin) stacks are a list of (rec, rec, attn) ``groups`` plus a
``tail`` of recurrent layers, RecurrentGemma's 26 = 8 * 3 + 2; the
training forward runs each group as one body (so remat checkpoints a whole
group, as the reference's), then the tail. The cache keeps the reference's
stacked layouts — ``k``/``v`` (L, B, S, KV, hd) (int8 with
``k_scale``/``v_scale`` (L, B, S, KV, 1) float32 under ``kv_cache_int8``; S
= min(slots, window) for a ring), the zone maps ``kmin``/``kmax`` (L, B,
nb, KV, hd) float32 under ``kv_block_prune``; the SSM states under
``layers``; the hybrid's per-group recurrent states and local-attention
ring, and its tail's states — and ``decode_step`` updates it in place.

A vlm's modality prefix (``batch["prefix_embeds"]``) enters only the
training/prefill forward; decode embeds tokens alone, as the reference's
does. ``cfg.remat != "none"`` recomputes each layer (each hybrid group) in
the backward pass (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``; no value changes). ``scan_layers``, ``seq_shard_resid``
and the reference's ``shardctx`` constraints place a layer loop and its
activations on a TPU mesh; on one device they change nothing, so they have
no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import numerics
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

F32 = torch.float32
VOCAB_MULT = 256  # pad vocab to a multiple of this, as the reference does


def vocab_padded(cfg) -> int:
    return L.round_up(cfg.vocab_size, VOCAB_MULT)


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------
def dense_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(cfg, generator, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(cfg, generator, device),
    }


def moe_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(cfg, generator, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "moe": M.moe_init(cfg, generator, device),
    }


def ssm_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "ssm": S.ssm_init(cfg, generator, device)}


def rec_layer_init(cfg, generator: torch.Generator, device) -> dict:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "rec": R.rglru_init(cfg, generator, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(cfg, generator, device),
    }


LAYER_INIT = {"dense": dense_layer_init, "moe": moe_layer_init,
              "ssm": ssm_layer_init, "vlm": dense_layer_init,
              "audio": dense_layer_init}


def _attn_window(cfg) -> Optional[int]:
    return cfg.sliding_window


def dense_layer_train(lp, x, positions, cfg, window=None):
    """x + attention + MLP over the whole sequence -> (x, zero aux loss)."""
    x = x + L.mha_train(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                        positions, cfg, window=window)
    x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, torch.zeros((), dtype=F32, device=x.device)


def moe_layer_train(lp, x, positions, cfg):
    """x + attention + the MoE layer -> (x, the layer's load-balancing
    loss)."""
    x = x + L.mha_train(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                        positions, cfg, window=_attn_window(cfg))
    y, aux = M.moe_apply(lp["moe"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                         cfg)
    return x + y, aux


def ssm_layer_train(lp, x, positions, cfg):
    """x + the Mamba-2 mixer -> (x, zero aux loss)."""
    x = x + S.ssm_train(lp["ssm"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg)
    return x, torch.zeros((), dtype=F32, device=x.device)


def rec_layer_train(lp, x, positions, cfg):
    """x + the RG-LRU sublayer + MLP -> (x, zero aux loss)."""
    x = x + R.rglru_train(lp["rec"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                          cfg)
    x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, torch.zeros((), dtype=F32, device=x.device)


def _group_train(lp, x, positions, cfg):
    """One hybrid group: rec1, rec2, then local attention over
    ``cfg.local_window`` -> (x, the three aux losses summed)."""
    x, a1 = rec_layer_train(lp["rec1"], x, positions, cfg)
    x, a2 = rec_layer_train(lp["rec2"], x, positions, cfg)
    x, a3 = dense_layer_train(lp["attn"], x, positions, cfg,
                              window=cfg.local_window)
    return x, a1 + a2 + a3


# the training body of each family whose layers are one block (the
# reference's ``_run_stack`` body table): (layer params, x, positions, cfg)
# -> (x, aux)
TRAIN_BODY = {
    "dense": lambda lp, x, pos, cfg: dense_layer_train(
        lp, x, pos, cfg, window=_attn_window(cfg)),
    "vlm": dense_layer_train,
    "audio": dense_layer_train,
    "moe": moe_layer_train,
    "ssm": ssm_layer_train,
}


def run_layers(layers, x, body, remat: bool):
    """``body(lp, x) -> (x, aux)`` over a list of layers, the aux losses
    summed in layer order from a float32 zero, as the reference's
    ``_scan_stack``; with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (recomputed in the backward pass)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lp in layers:
        x, aux_l = (checkpoint(body, lp, x, use_reentrant=False) if remat
                    else body(lp, x))
        aux = aux + aux_l
    return x, aux


def remat_enabled(cfg) -> bool:
    """Whether a layer loop checkpoints its layers: ``cfg.remat`` asks for
    it and grad is enabled (a forward under ``no_grad``, as serving runs
    it, has no backward pass to recompute for)."""
    return cfg.remat != "none" and torch.is_grad_enabled()


def _put(cache: dict, i: int, new: dict) -> None:
    """Write layer ``i``'s new state tensors into the stacked cache."""
    for k, v in new.items():
        cache[k][i] = v


@dataclasses.dataclass(frozen=True)
class DecoderLM:
    """Family-dispatching decoder-only LM on one device.

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
        the embedding table, the unembedding, then each layer's weights in
        order (hybrid: each group's rec1, rec2, attn, then the tail)."""
        cfg, dev = self.cfg, self.device
        params: dict = {
            "embed": L.embedding_init(cfg, vocab_padded(cfg), generator, dev),
            "final_ln": L.rmsnorm_init(cfg.d_model, dev),
        }
        if cfg.family == "hybrid":
            n_groups, tail = divmod(cfg.n_layers, 3)
            params["groups"] = [{
                "rec1": rec_layer_init(cfg, generator, dev),
                "rec2": rec_layer_init(cfg, generator, dev),
                "attn": dense_layer_init(cfg, generator, dev),
            } for _ in range(n_groups)]
            if tail:
                params["tail"] = [rec_layer_init(cfg, generator, dev)
                                  for _ in range(tail)]
        else:
            layer_init = LAYER_INIT[cfg.family]
            params["layers"] = [layer_init(cfg, generator, dev)
                                for _ in range(cfg.n_layers)]
        return params

    # -- train forward ------------------------------------------------------
    def _embed_inputs(self, params, batch):
        """Token (+ optional modality-prefix) embedding -> (x, positions
        0..S_total-1)."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        if cfg.n_prefix_embeds:
            pre = batch["prefix_embeds"].to(x.dtype)  # (B, P, D) stub frontend
            x = torch.cat([pre, x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        return x, positions

    def forward(self, params, batch):
        """(B, S) tokens -> ((B, S_total, vocab_pad) float32 logits, aux)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        x, aux = self._run_stack(params, x, positions)
        x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg.tie_embeddings), aux

    def _run_stack(self, params, x, positions):
        cfg = self.cfg
        remat = remat_enabled(cfg)
        # Python loops over the layer lists: the reference's scan_layers,
        # seq_shard_resid and shardctx constraints shape a TPU program and
        # its mesh placement, and have no effect on one device.
        if cfg.family == "hybrid":
            x, aux = run_layers(
                params["groups"], x,
                lambda lp, x: _group_train(lp, x, positions, cfg), remat)
            if "tail" in params:
                x, aux_tail = run_layers(
                    params["tail"], x,
                    lambda lp, x: rec_layer_train(lp, x, positions, cfg),
                    remat)
                aux = aux + aux_tail
            return x, aux
        if cfg.family not in TRAIN_BODY:
            raise NotImplementedError(
                f"{cfg.name}: no training body for the {cfg.family} family")
        layer = TRAIN_BODY[cfg.family]
        return run_layers(params["layers"], x,
                          lambda lp, x: layer(lp, x, positions, cfg), remat)

    def loss_fn(self, params, batch):
        """-> (total loss, {"loss", "aux_loss"}); with a modality prefix the
        loss is taken on the text suffix only."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        if cfg.n_prefix_embeds:
            logits = logits[:, cfg.n_prefix_embeds:, :]
        loss = L.xent_loss(logits, batch["labels"], cfg.vocab_size)
        return loss + aux, {"loss": loss, "aux_loss": aux}

    def prefill(self, params, batch):
        """Inference forward over the full prompt -> (last-token logits (B,
        1, vocab_pad) float32, aux). ``cfg.prefill_last_only`` unembeds the
        final position alone; otherwise the full logits are sliced."""
        cfg = self.cfg
        if not cfg.prefill_last_only:
            logits, aux = self.forward(params, batch)
            return logits[:, -1:, :], aux
        x, positions = self._embed_inputs(params, batch)
        x, aux = self._run_stack(params, x, positions)
        x = L.rmsnorm(params["final_ln"], x[:, -1:, :], cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg.tie_embeddings), aux

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, slots: int, dtype=None) -> dict:
        cfg, dev = self.cfg, self.device
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        dt = self.dtype if dtype is None else dtype

        def stacked(n: int, state: dict) -> dict:
            return {k: v[None].repeat(n, *([1] * v.dim()))
                    for k, v in state.items()}

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv_slots(window):
            return min(slots, window) if window else slots

        pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if cfg.family == "ssm":
            st = S.ssm_init_state(cfg, batch, dt, dev)
            return {"layers": stacked(cfg.n_layers, st), "pos": pos}
        if cfg.family == "hybrid":
            n_groups, tail = divmod(cfg.n_layers, 3)
            w = kv_slots(cfg.local_window)
            rec = R.rglru_init_state(cfg, batch, dt, dev)
            cache = {"groups": {
                "rec1": stacked(n_groups, rec), "rec2": stacked(n_groups, rec),
                "k": zeros((n_groups, batch, w, kv, hd)),
                "v": zeros((n_groups, batch, w, kv, hd))}}
            if tail:
                cache["tail"] = stacked(tail, rec)
            cache["pos"] = pos
            return cache
        w = kv_slots(cfg.sliding_window)
        kv_dt = torch.int8 if cfg.kv_cache_int8 else dt
        shape = (cfg.n_layers, batch, w, kv, hd)
        cache = {"k": zeros(shape, kv_dt), "v": zeros(shape, kv_dt),
                 "pos": pos}
        if cfg.kv_cache_int8:
            cache["k_scale"] = zeros((*shape[:-1], 1), F32)
            cache["v_scale"] = zeros((*shape[:-1], 1), F32)
        if cfg.kv_block_prune:
            nb = w // cfg.kv_block_size
            # zone-map "+infinity": dtype-derived so it survives bf16 casts
            big = numerics.finite_max(torch.bfloat16)
            zshape = (cfg.n_layers, batch, nb, kv, hd)
            cache["kmin"] = torch.full(zshape, big, dtype=F32, device=dev)
            cache["kmax"] = torch.full(zshape, -big, dtype=F32, device=dev)
        return cache

    def decode_step(self, params, cache, tokens, pos, *,
                    visits: list | None = None):
        """tokens: (B, 1) int; pos: (B,) absolute positions -> (logits (B, 1,
        vocab_pad) float32, cache). The cache is updated in place and its
        ``pos`` set to ``pos + 1``. ``visits``, when a list, receives each
        layer's (block ids, bounds) under ``kv_block_prune``."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        if cfg.family == "ssm":
            states = cache["layers"]
            for i, lp in enumerate(params["layers"]):
                xn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
                y, st = S.ssm_decode(lp["ssm"], xn,
                                     {k: v[i] for k, v in states.items()}, cfg)
                _put(states, i, st)
                x = x + y
        elif cfg.family == "hybrid":
            groups = cache["groups"]
            for i, lp in enumerate(params["groups"]):
                x = self._rec(lp["rec1"], x, groups["rec1"], i)
                x = self._rec(lp["rec2"], x, groups["rec2"], i)
                x = self._attn(lp["attn"], x, pos, groups["k"][i],
                               groups["v"][i], None, cfg.local_window, visits)
                x = x + L.mlp(lp["attn"]["mlp"],
                              L.rmsnorm(lp["attn"]["ln2"], x, cfg.norm_eps))
            for i, lp in enumerate(params.get("tail", [])):
                x = self._rec(lp, x, cache["tail"], i)
        else:
            extra_keys = [k for k in ("k_scale", "v_scale", "kmin", "kmax")
                          if k in cache]
            for i, lp in enumerate(params["layers"]):
                extras = {k: cache[k][i] for k in extra_keys}
                x = self._attn(lp, x, pos, cache["k"][i], cache["v"][i],
                               extras, _attn_window(cfg), visits)
                xn2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
                if cfg.family == "moe":
                    y2, _ = M.moe_apply(lp["moe"], xn2, cfg)
                else:
                    y2 = L.mlp(lp["mlp"], xn2)
                x = x + y2
        x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
        cache["pos"] = pos + 1
        return logits, cache

    def _attn(self, lp, x, pos, k, v, extras, window, visits):
        """x + the layer's self-attention over its cache (written in place)."""
        xn = L.rmsnorm(lp["ln1"], x, self.cfg.norm_eps)
        return x + L.mha_decode(lp["attn"], xn, pos, k, v, self.cfg,
                                window=window, extras=extras,
                                backend=self.backend, visits=visits)

    def _rec(self, lp, x, states: dict, i: int):
        """A recurrent layer of the hybrid: RG-LRU, then the MLP; layer
        ``i``'s state in the stacked ``states`` updated in place."""
        cfg = self.cfg
        xn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, st = R.rglru_decode(lp["rec"], xn,
                               {k: v[i] for k, v in states.items()}, cfg)
        _put(states, i, st)
        x = x + y
        return x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))

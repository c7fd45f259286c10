"""Model registry: ModelConfig -> runnable model + sharding policy + specs.

Ports ``repro/models/registry.py``. Every family decode-serves; what is
refused here is what the reference itself cannot run (see
``unsupported``), with the reason, rather than failing somewhere inside a
step.

The per-arch TP policy (DESIGN.md §5): with a fixed 16-wide `model` mesh
axis, attention sharding adapts to head divisibility —

  policy A: heads and kv_heads both divide 16     -> shard both (full TP attn)
  policy B: only heads divide 16                  -> shard q heads, replicate kv
  policy C: heads don't divide 16                 -> replicate attention,
            TP carries the FFN / experts / vocab (the parameter bulk)

``make_cell`` gives one dry-run cell's inputs as meta tensors (the
reference's ``ShapeDtypeStruct``s) with their ``P`` specs; these are
metadata and allocate nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import DEFAULT_RULES, P
from repro_torch.models.transformer import DecoderLM, vocab_padded

__all__ = ["build_model", "shape_applicable", "vocab_padded", "unsupported",
           "TP", "attn_policy", "sharding_rules", "batch_axes", "CellSpec",
           "cache_pspecs_for", "make_cell"]

TP = 16  # model-axis width of the production mesh


def _encdec(cfg) -> bool:
    return cfg.family == "audio" and bool(cfg.encoder_layers)


def unsupported(cfg) -> str | None:
    """Why ``cfg`` cannot decode — the reference cannot run it either — or
    None."""
    window = cfg.sliding_window or (cfg.local_window
                                    if cfg.family == "hybrid" else None)
    kv_caching = cfg.family != "ssm"
    if cfg.kv_block_prune and kv_caching and window:
        return (f"kv_block_prune with a {window}-slot window: block pruning "
                f"targets full caches (the reference asserts it)")
    if cfg.kv_block_prune and _encdec(cfg):
        return ("kv_block_prune on the encoder-decoder: its decoder's "
                "attention gets no zone maps (the reference's neither)")
    if cfg.kv_cache_int8 and (cfg.family == "hybrid" or _encdec(cfg)):
        return (f"kv_cache_int8 on the {cfg.family} family: its cache holds "
                f"no scales (the reference's neither)")
    return None


def build_model(cfg, device=None, backend: str = "auto"):
    """The runnable model for ``cfg`` on ``device`` (None means ``cuda``,
    which raises without a card; pass ``device="cpu"`` for the plain
    versions): ``EncDecLM`` for an audio config with encoder layers,
    ``DecoderLM`` otherwise."""
    why = unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")
    cls = EncDecLM if _encdec(cfg) else DecoderLM
    return cls(cfg, resolve_device(device), ops.check_backend(backend))


def shape_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """Whether the (arch x shape) cell runs, and why not."""
    seq, batch, kind = SHAPES[shape_name]
    if shape_name == "long_500k":
        bounded = (cfg.family in ("ssm", "hybrid")
                   or cfg.sliding_window is not None)
        if not bounded:
            return False, ("pure full attention: 500k decode needs an O(500k)-"
                           "resident KV cache built by a quadratic prefill "
                           "(DESIGN.md §4)")
    return True, ""


def attn_policy(cfg, tp: int = TP) -> str:
    if cfg.family == "ssm":
        return "A"  # ssm heads checked below
    if cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
        return "A"
    if cfg.n_heads % tp == 0:
        return "B"
    return "C"


def sharding_rules(cfg, tp: int = TP) -> dict[str, Optional[str]]:
    rules = dict(DEFAULT_RULES)
    pol = attn_policy(cfg, tp)
    if cfg.family == "ssm":
        h_ssm = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        rules["heads"] = "model" if h_ssm % tp == 0 else None
        rules["kv_heads"] = None
    elif pol == "B":
        rules["kv_heads"] = None
    elif pol == "C":
        rules["heads"] = None
        rules["kv_heads"] = None
    return rules


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Everything the dry run needs for one (arch x shape) cell."""
    arch: str
    shape: str
    kind: str                 # train | prefill | decode
    inputs: dict              # name -> meta tensor
    input_pspecs: dict        # name -> P
    cache_specs: Any = None   # decode only: tree of meta tensors
    cache_pspecs: Any = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(cfg, seq: int, batch: int, kind: str, ba) -> tuple[dict, dict]:
    """Token/label/frontend-stub specs for train/prefill."""
    dt_emb = getattr(torch, cfg.param_dtype)
    inputs: dict = {}
    pspecs: dict = {}
    if _encdec(cfg):
        enc_len = max(8, seq // 4)
        inputs["enc_embeds"] = _meta((batch, enc_len, cfg.d_model), dt_emb)
        pspecs["enc_embeds"] = P(ba, None, None)
        inputs["tokens"] = _meta((batch, seq), torch.int32)
        pspecs["tokens"] = P(ba, None)
        if kind == "train":
            inputs["labels"] = _meta((batch, seq), torch.int32)
            pspecs["labels"] = P(ba, None)
        return inputs, pspecs
    text_len = seq - cfg.n_prefix_embeds
    if text_len <= 0:
        raise ValueError(f"{seq} positions leave no text after "
                         f"{cfg.n_prefix_embeds} prefix embeddings")
    inputs["tokens"] = _meta((batch, text_len), torch.int32)
    pspecs["tokens"] = P(ba, None)
    if cfg.n_prefix_embeds:
        inputs["prefix_embeds"] = _meta(
            (batch, cfg.n_prefix_embeds, cfg.d_model), dt_emb)
        pspecs["prefix_embeds"] = P(ba, None, None)
    if kind == "train":
        # labels cover the text positions (the loss skips the prefix)
        inputs["labels"] = _meta((batch, text_len), torch.int32)
        pspecs["labels"] = P(ba, None)
    return inputs, pspecs


def cache_pspecs_for(cfg, cache_specs, batch: int, multi_pod: bool, rules):
    """P tree matching an ``init_cache`` tree."""
    ba = batch_axes(multi_pod)
    b_spec = ba if batch > 1 else None
    heads_rule = rules.get("heads")
    kv_rule = rules.get("kv_heads")

    def spec_for(leaf, arr):
        # leaf names: k/v (L,B,slots,KV,hd); k_scale/v_scale (L,B,slots,KV,1);
        # kmin/kmax (L,B,nb,KV,hd); ssm (L,B,H,hd,state); conv_* (L,B,W,C);
        # h (L,B,dr); pos (B,)
        nd = arr.dim()
        if nd == 1:
            return P(b_spec)
        if nd == 5 and leaf in ("k", "v", "xk", "xv", "k_scale", "v_scale",
                                "kmin", "kmax"):
            if kv_rule == "model":
                return P(None, b_spec, None, "model", None)
            # kv replicated over model: shard cache slots/blocks over model
            slots = arr.shape[2]
            slot_axes = "model" if slots % TP == 0 else None
            return P(None, b_spec, slot_axes, None, None)
        if nd == 5:  # ssm state (L,B,H,hd,state)
            return P(None, b_spec, heads_rule, None, None)
        if nd == 4:  # conv state (L,B,W,C) or group-stacked (G,B,w,dr)
            return P(None, b_spec, None, "model")
        if nd == 3:  # h (L,B,dr)
            return P(None, b_spec, "model")
        if nd == 2:
            return P(None, b_spec)
        return P(*([None] * nd))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (spec_for(k, v) if isinstance(v, torch.Tensor)
                        else walk(v)) for k, v in tree.items()}
        return tree

    return walk(cache_specs)


def make_cell(arch: str, shape_name: str, multi_pod: bool = False,
              cfg=None) -> CellSpec:
    """The (inputs, specs, cache) bundle of one dry-run cell, on meta."""
    cfg = cfg if cfg is not None else get_config(arch)
    seq, batch, kind = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")
    ba = batch_axes(multi_pod)
    rules = sharding_rules(cfg)

    if kind in ("train", "prefill"):
        inputs, pspecs = _token_specs(cfg, seq, batch, kind, ba)
        return CellSpec(arch, shape_name, kind, inputs, pspecs)

    # decode: one new token against a cache of seq_len
    model = build_model(cfg, device="meta")
    dt = getattr(torch, cfg.param_dtype)
    if _encdec(cfg):
        cache_specs = model.init_cache(batch, seq, dt, enc_len=max(8, seq // 4))
    else:
        cache_specs = model.init_cache(batch, seq, dt)
    inputs = {"tokens": _meta((batch, 1), torch.int32),
              "pos": _meta((batch,), torch.int32)}
    b_spec = ba if batch > 1 else None
    pspecs = {"tokens": P(b_spec, None), "pos": P(b_spec)}
    cache_p = cache_pspecs_for(cfg, cache_specs, batch, multi_pod, rules)
    return CellSpec(arch, shape_name, kind, inputs, pspecs,
                    cache_specs=cache_specs, cache_pspecs=cache_p)

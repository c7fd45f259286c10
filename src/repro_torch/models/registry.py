"""Model registry: ModelConfig -> runnable model.

Ports ``build_model`` and ``shape_applicable`` of
``repro/models/registry.py`` for one device (no mesh, no sharding policy).
Every family decode-serves; what is refused here is what the reference
itself cannot run (see ``unsupported``), with the reason, rather than
failing somewhere inside a step.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM, vocab_padded

__all__ = ["build_model", "shape_applicable", "vocab_padded", "unsupported"]


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

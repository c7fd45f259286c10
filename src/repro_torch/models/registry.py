"""Model registry: ModelConfig -> runnable model.

Ports ``build_model`` of ``repro/models/registry.py`` for one device (no
mesh, no sharding policy). What the port runs so far is the dense family's
decode-serving path with a full cache, with or without the zone-map KV
block prune; every other configuration is refused here with the reason,
rather than failing somewhere inside a step.
"""
from __future__ import annotations

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import DecoderLM, vocab_padded

__all__ = ["build_model", "vocab_padded", "unsupported"]


def unsupported(cfg) -> str | None:
    """Why the port cannot run ``cfg`` yet (see ROADMAP.md), or None."""
    if cfg.family != "dense":
        return (f"family {cfg.family!r}: only the dense family is ported "
                f"(MoE, SSM, hybrid, encoder-decoder and modality-prefix "
                f"models come later)")
    if cfg.n_prefix_embeds or cfg.frontend or cfg.encoder_layers:
        return "modality prefixes and encoders are not ported yet"
    if cfg.sliding_window is not None:
        return "the sliding-window ring cache is not ported yet"
    if cfg.kv_cache_int8:
        return ("int8 KV caches are not ported yet (the block-visit kernel "
                "takes no scales)")
    return None


def build_model(cfg, device=None, backend: str = "auto") -> DecoderLM:
    """The runnable model for ``cfg`` on ``device`` (None means ``cuda``,
    which raises without a card; pass ``device="cpu"`` for the plain
    versions)."""
    why = unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")
    return DecoderLM(cfg, resolve_device(device), ops.check_backend(backend))

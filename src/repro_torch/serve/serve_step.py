"""Serving steps: prefill, single-token decode and greedy sampling.

Ports ``make_serve_step``, ``make_prefill`` and ``greedy_sample`` of
``repro/serve/serve_step.py``. The reference jits the step and donates the
cache; here the step runs eagerly and ``decode_step`` updates the cache in
place, so steady-state decode allocates no new cache either.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_serve_step(model) -> Callable:
    """(params, cache, tokens(B,1), pos(B,)) -> (logits, cache')."""

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step


def make_prefill(model) -> Callable:
    """(params, batch) -> (last-token logits, aux)."""

    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, 1, V_pad) -> (B, 1) int32 argmax over the un-padded vocabulary;
    ties go to the first index, as ``jnp.argmax``'s do."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)

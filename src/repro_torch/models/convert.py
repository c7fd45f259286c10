"""Carry the reference's parameters across to the port.

``from_jax_params`` takes the reference's parameter values of any family as
a tree of numpy arrays — ``jax.tree.map(np.asarray, split_tree(params)[0])``
— and returns the port's tree: the same names and per-layer shapes, each
stacked layer tree unstacked into a list (``layers``; the hybrid's
``groups`` of (rec1, rec2, attn) and its ``tail``; the encoder-decoder's
``enc_layers`` and ``dec_layers``), every other leaf (``embed``,
``final_ln``, ``enc_ln``) as it is. Nothing here imports JAX: bfloat16
arrays arrive as numpy arrays of a 2-byte float type and are reinterpreted
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

STACKS = ("layers", "groups", "tail", "enc_layers", "dec_layers")


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def from_jax_params(np_tree: dict, cfg, device) -> dict:
    """The reference's parameter values (numpy tree) -> the port's tree."""
    device = torch.device(device)
    want = {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
            "enc_layers": cfg.encoder_layers}
    out = {}
    for name, sub in np_tree.items():
        if name not in STACKS:
            out[name] = _map(sub, lambda a: to_tensor(a, device))
            continue
        n = _first_leaf(sub).shape[0]
        if name in want and n != want[name]:
            raise ValueError(f"{n} stacked {name}, config has {want[name]}")
        out[name] = [_map(sub, lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                        device))
                     for i in range(n)]
    return out

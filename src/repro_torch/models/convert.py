"""Carry the reference's parameters across to the port.

``from_jax_params`` takes the reference's dense-model parameter values as a
tree of numpy arrays — ``jax.tree.map(np.asarray, split_tree(params)[0])``:
stacked ``layers`` (leading axis L) with ``ln1``, ``attn.{wq, wk, wv, wo,
q_norm, k_norm}``, ``ln2``, ``mlp.{wi_gate, wi_up, wo}``; ``embed.{table,
unembed}``; ``final_ln`` — and returns the port's tree: the same names and
per-layer shapes, the layers unstacked into a list. Nothing here imports
JAX: bfloat16 arrays arrive as numpy arrays of a 2-byte float type and are
reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(np_tree: dict, cfg, device) -> dict:
    """The reference's parameter values (numpy tree) -> the port's tree."""
    device = torch.device(device)
    layers = np_tree["layers"]
    n = np.asarray(layers["ln1"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers, config has {cfg.n_layers}")
    return {
        "embed": _map(np_tree["embed"], lambda a: to_tensor(a, device)),
        "final_ln": to_tensor(np_tree["final_ln"], device),
        "layers": [_map(layers, lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                         device))
                   for i in range(n)],
    }

"""Parameter initialisers and logical sharding axes for the port's models.

Ports ``repro/models/params.py``. A parameter is a plain tensor (no
``Param`` wrapper), and random draws come from an explicit
``torch.Generator``. The two packages draw different numbers from the same
seed; the parity tests carry the reference's weights across with
``models.convert.from_jax_params``.

The logical axes the reference tags each leaf with ("embed", "heads",
"ff", "vocab", ...) live in a table here (``LEAF_AXES``) keyed by the
leaf's place in the tree; ``axes_for`` reads a parameter tree's axes from
it and ``param_axes`` gives a config's. A rules table maps logical axes to
mesh axes (``DEFAULT_RULES``, the one place the DP/TP layout is decided),
``pspec_tree`` turns axes into ``P`` specs and ``placements`` turns a spec
into DTensor placements on a ``DeviceMesh`` (the counterpart of
``NamedSharding``). The per-layer lists carry no "layers" axis: the
reference's stacked axis is replicated under every rule.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

TRUNC = 2.0  # truncated normal on [-TRUNC, TRUNC], as the reference draws


def truncated_normal(shape, generator: torch.Generator,
                     device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32, by the inverse CDF of a
    uniform draw from ``generator``."""
    lo = 0.5 * (1.0 + math.erf(-TRUNC / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(TRUNC / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return x.clamp_(-TRUNC, TRUNC)


# A draw of more elements than this is made one slice of the first axis at a
# time, so its float32 temporaries stay small (arctic-480b's expert weights,
# 128 x 7168 x 4864, would take 18 GB per float32 temporary at once).
DRAW_CHUNK_ELEMS = 2 ** 30


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal times ``scale`` (default ``fan_in ** -0.5``, fan_in
    = the first axis), drawn in float32 and cast to ``dtype``."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":  # no values to draw
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    if math.prod(shape) <= DRAW_CHUNK_ELEMS:
        return (truncated_normal(shape, generator, device) * s).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = truncated_normal(shape[1:], generator, device) * s
    return out


def zeros_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def leaves(tree):
    """The tensors of a nested dict/list parameter tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def map_tree(tree, fn):
    """``tree`` with each leaf replaced by ``fn(leaf)``; dicts and lists
    keep their structure."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def unflatten(tree, flat):
    """The structure of ``tree`` filled with ``flat`` (in ``leaves``
    order)."""
    it = iter(flat)
    out = map_tree(tree, lambda _: next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


# ---------------------------------------------------------------------------
# logical axes, specs and placements
# ---------------------------------------------------------------------------
class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh-axis name, a
    tuple of names (the dim split over them, the first outermost) or None
    (not split). A one-name tuple is kept as the name, as JAX keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# Logical-axis -> mesh-axis rules. None = replicate. The default TP layout:
# heads/ff/vocab/experts shard over "model"; everything else replicated
# (DP gradients all-reduced, ZeRO-1 shards optimizer state over "data").
DEFAULT_RULES: dict[str, Optional[str]] = {
    "layers": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_ff": None,
    "state": None,
    "rnn": "model",
    "conv": None,
}

_ATTN = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed"),
         "q_norm": ("head_dim",), "k_norm": ("head_dim",)}
_MLP = {"wi_gate": ("embed", "ff"), "wi_up": ("embed", "ff"),
        "wo": ("ff", "embed")}

# The axes of each leaf, by the name of the dict that holds it; the
# reference's initialisers tag the same leaves with the same names.
LEAF_AXES: dict[str, dict[str, tuple]] = {
    "embed": {"table": ("vocab", "embed"), "unembed": ("embed", "vocab")},
    "attn": _ATTN, "xattn": _ATTN,
    "mlp": _MLP, "shared": _MLP, "dense": _MLP,
    "moe": {"router": ("embed", "experts"),
            "wi_gate": ("experts", "embed", "expert_ff"),
            "wi_up": ("experts", "embed", "expert_ff"),
            "wo": ("experts", "expert_ff", "embed")},
    "ssm": {"w_z": ("embed", "rnn"), "w_x": ("embed", "rnn"),
            "w_B": ("embed", "state"), "w_C": ("embed", "state"),
            "w_dt": ("embed", "heads"), "conv_x": ("conv", "rnn"),
            "conv_B": ("conv", "state"), "conv_C": ("conv", "state"),
            "A_log": ("heads",), "dt_bias": ("heads",), "D": ("heads",),
            "norm": ("rnn",), "w_out": ("rnn", "embed")},
    "rec": {"w_in": ("embed", "rnn"), "w_gate": ("embed", "rnn"),
            "conv": ("conv", "rnn"), "w_r": ("rnn",), "b_r": ("rnn",),
            "w_i": ("rnn",), "b_i": ("rnn",), "lam": ("rnn",),
            "w_out": ("rnn", "embed")},
}
NORMS = ("ln1", "ln2", "lnx", "final_ln", "enc_ln")  # RMSNorm scales (d,)


def _leaf_axes(path: tuple) -> tuple:
    name = path[-1]
    if name in NORMS:
        return ("embed",)
    parent = next((p for p in reversed(path[:-1]) if isinstance(p, str)),
                  None)
    try:
        return LEAF_AXES[parent][name]
    except KeyError:
        raise KeyError(f"no logical axes for parameter {'/'.join(map(str, path))}"
                       ) from None


def _map_path(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: an axes tuple, a spec, a placements tuple)."""
    if isinstance(tree, dict):
        return {k: _map_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def axes_for(params) -> dict:
    """A parameter tree -> the same tree of logical-axis tuples (one name
    or None per dim), checked against each leaf's rank."""
    def one(path, t):
        axes = _leaf_axes(path)
        if len(axes) != t.dim():
            raise ValueError(f"{'/'.join(map(str, path))}: {t.dim()} dims, "
                             f"axes {axes}")
        return axes
    return _map_path(params, one)


def param_axes(cfg) -> dict:
    """The logical axes of ``cfg``'s parameter tree (built on ``meta``,
    nothing allocated)."""
    from repro_torch.models.registry import build_model
    return axes_for(abstract_params(build_model(cfg, device="meta")))


def abstract_params(model) -> dict:
    """``model``'s parameter tree on ``meta``: shapes and dtypes, no
    storage (the reference's ``jax.eval_shape(model.init, key)``)."""
    if model.device.type != "meta":
        raise ValueError(f"abstract_params needs a meta model, got "
                         f"{model.device}")
    return model.init(torch.Generator())


def pspec_tree(axes_tree, rules: dict[str, Optional[str]] | None = None):
    """Axes tree -> ``P`` tree via the rules table."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    return _map_path(axes_tree, lambda _, axes: P(
        *(rules.get(a) if a is not None else None for a in axes)))


def shard_shape(shape, spec: P, axis_sizes: dict[str, int]) -> tuple:
    """The per-device shape of a tensor of ``shape`` split by ``spec`` over
    mesh axes of ``axis_sizes`` (JAX's ``NamedSharding.shard_shape``)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if out[d] % axis_sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{axis_sizes[a]} ways")
            out[d] //= axis_sizes[a]
    return tuple(out)


def placements(spec: P, mesh) -> tuple:
    """``spec`` -> one DTensor placement per mesh dim: ``Shard(d)`` on each
    mesh dim that splits tensor dim d, ``Replicate()`` on the others. A dim
    split over several mesh axes lists them in mesh order (outermost
    first), as JAX orders them."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def sharding_tree(params_tree, mesh,
                  rules: dict[str, Optional[str]] | None = None):
    """Parameter tree -> matching tree of placement tuples (the
    reference's ``NamedSharding`` tree)."""
    return _map_path(pspec_tree(axes_for(params_tree), rules),
                     lambda _, spec: placements(spec, mesh))


def abstract_like(tree):
    """A tensor tree -> the same tree on ``meta`` (no allocation)."""
    return map_tree(tree, lambda t: torch.empty_like(t, device="meta"))


def local_shape(shape, mesh, pls) -> tuple:
    """The shape of this rank's shard of a tensor of ``shape`` laid out by
    ``pls`` on ``mesh``; a split dim must divide evenly, as the
    reference's shardings demand."""
    shape = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split {n} ways")
            shape[p.dim] //= n
    return tuple(shape)


def shard_like(t: torch.Tensor, mesh, pls, device=None) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype laid out by ``pls``.

    On ``meta`` (or with ``device`` given) only this rank's shard is made,
    from ``torch.empty`` (the dry run's inputs; ``t`` may be a meta
    tensor). Otherwise ``t`` holds the global value and each rank keeps its
    own slice of it, with no communication."""
    if device is not None or t.device.type == "meta":
        dev = t.device if device is None else torch.device(device)
        local = torch.empty(local_shape(t.shape, mesh, pls), dtype=t.dtype,
                            device=dev)
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride())
    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params, mesh, rules: dict[str, Optional[str]] | None
                      = None, device=None):
    """A parameter tree -> the same tree of DTensors laid out under
    ``rules`` (see ``shard_like`` for ``device``)."""
    pls = sharding_tree(params, mesh, rules)
    flat = [shard_like(t, mesh, p, device) for t, p in
            zip(leaves(params), spec_leaves(pls))]
    return unflatten(params, flat)


def spec_leaves(tree):
    """The leaves of an axes, spec or placements tree (tuples are leaves
    there), in ``leaves`` order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from spec_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from spec_leaves(v)
    else:
        yield tree

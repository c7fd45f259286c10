"""The port's sharding layer against the reference's, on the CPU.

Specs, for all ten full configs, from ``jax.eval_shape`` (nothing is
allocated): the TP policy and rules, every parameter's logical axes (the
reference stacks a layer axis that the port's per-layer lists do not
carry; ``models.convert`` unstacks it the same way), the ``P`` specs, the
ZeRO-1 specs of the optimizer state, each cell's inputs and their specs,
and the cache specs per leaf. Per-device argument bytes of the 32 dense and
vlm cells (two meshes) against the reference's ``NamedSharding.shard_shape``
on an ``AbstractMesh``.

Then a real 2 x 4 mesh: eight gloo processes (a ``FileStore`` in
``tmp_path``) run one train step of a reduced smollm-360m in float32 with
the reference's weights, the rules of ``tests/test_system.py``'s mini
dry run (``sharding_rules(cfg, tp=4)`` with heads and kv heads on
`model`), ZeRO-1 over `data` (2): the loss within ``F32_LOSS_ATOL`` (5e-6)
and the gathered new parameters within ``STEP_ATOL`` (1e-5) of the
reference's one-device step, as ``tests/test_torch_train.py`` holds the
one-device port; again with ``attn_batch_shard`` and ``seq_shard_resid``
on; and, with 2 kv heads, under policy B's rules (query heads on `model`,
kv heads replicated: each rank attends with the kv head of its query
head). The same world runs ``compressed_psum`` on (8, 256, 64) gradients: within
1e-6 of the reference's (8 forced host devices in a subprocess, as
``tests/test_distributed.py`` runs it) and within 0.02 relative of the
exact mean.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jax_get_config
from repro.models import params as jparams
from repro.models import registry as jreg
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train.optimizer import opt_state_pspecs as jax_opt_state_pspecs
from repro.train.optimizer import zero1_pspec as jax_zero1_pspec
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import params, registry
from repro_torch.models.convert import from_jax_params
from repro_torch.train.optimizer import opt_state_pspecs

ROOT = Path(__file__).resolve().parents[1]
F32_LOSS_ATOL, STEP_ATOL = 5e-6, 1e-5
STACKED = ("layers", "groups", "tail", "enc_layers", "dec_layers")
DENSE_VLM = [a for a in ARCH_IDS
             if get_config(a).family in dryrun.FAMILIES]


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    model = jreg.build_model(jax_get_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    return params.abstract_params(registry.build_model(get_config(arch),
                                                       device="meta"))


def _paths(tree, full=(), keys=(), stacked=False):
    """(path with list indices, path of dict keys alone, inside a layer
    list) of each leaf of a port tree: the second finds the reference's
    leaf, whose layer lists are stacked arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, full + (k,), keys + (k,), stacked)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, full + (i,), keys, True)
    else:
        yield full, keys, stacked


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("tp", [16, 4])
def test_policy_and_rules_match_reference(arch, tp):
    jc, c = jax_get_config(arch), get_config(arch)
    assert registry.attn_policy(c, tp) == jreg.attn_policy(jc, tp)
    assert registry.sharding_rules(c, tp) == jreg.sharding_rules(jc, tp)
    assert registry.TP == jreg.TP
    assert params.DEFAULT_RULES == jparams.DEFAULT_RULES
    assert registry.batch_axes(True) == jreg.batch_axes(True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_specs_match_reference(arch):
    """Logical axes, P specs (under the arch's rules) and ZeRO-1 specs of
    every leaf equal the reference's, the stacked layer axis aside. Where
    the reference's ZeRO-1 splits that stacked axis itself over `data`
    (32 smollm layers), a layer list has no such axis: each layer's state
    is split on its first free divisible dim, the reference's
    ``zero1_pspec`` of the unstacked leaf (the same bytes per device, which
    ``test_argument_bytes_match_reference`` holds)."""
    ref = _ref_abstract(arch)
    ref_vals, ref_axes = jparams.split_tree(ref)
    port = _port_abstract(arch)
    axes = params.param_axes(get_config(arch))
    rules = registry.sharding_rules(get_config(arch))
    ref_specs = jparams.pspec_tree(ref_axes, rules)
    ref_opt = jax_opt_state_pspecs(ref, rules, data_size=16)["master"]
    port_specs = params.pspec_tree(axes, rules)
    port_opt = opt_state_pspecs(port, rules, data_size=16)["master"]
    n = 0
    for full, keys, stacked in _paths(port):
        drop = 1 if stacked else 0
        assert tuple(_get(ref_axes, keys))[drop:] == _get(axes, full)
        assert tuple(_get(ref_specs, keys))[drop:] == tuple(
            _get(port_specs, full))
        want = (_get(ref_opt, keys) if not stacked else jax_zero1_pspec(
            _get(ref_axes, keys)[1:], _get(ref_vals, keys).shape[1:], rules,
            data_size=16))
        assert tuple(want) == tuple(_get(port_opt, full))
        assert tuple(_get(ref_vals, keys).shape)[drop:] == tuple(
            _get(port, full).shape)
        n += 1
    assert n == len(list(params.leaves(port)))
    assert params.pspec_tree(params.axes_for(port)) == params.pspec_tree(
        axes, params.DEFAULT_RULES)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_cell_matches_reference(arch, multi_pod):
    """Each cell's input names, shapes, dtypes and specs, and its cache
    leaves and their specs, equal the reference's; the skipped long_500k
    cells raise the same ValueError."""
    for shape in SHAPES:
        ok, why = registry.shape_applicable(get_config(arch), shape)
        assert (ok, why) == jreg.shape_applicable(jax_get_config(arch), shape)
        if not ok:
            with pytest.raises(ValueError) as a:
                registry.make_cell(arch, shape, multi_pod)
            with pytest.raises(ValueError) as b:
                jreg.make_cell(arch, shape, multi_pod)
            assert str(a.value) == str(b.value)
            continue
        c = registry.make_cell(arch, shape, multi_pod)
        r = jreg.make_cell(arch, shape, multi_pod)
        assert (c.kind, list(c.inputs)) == (r.kind, list(r.inputs))
        for k, t in c.inputs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == r.inputs[k].shape
            assert str(t.dtype).split(".")[-1] == str(r.inputs[k].dtype)
            assert tuple(c.input_pspecs[k]) == tuple(r.input_pspecs[k])
        if c.kind != "decode":
            assert c.cache_specs is None and r.cache_specs is None
            continue
        ref_flat = {tuple(k.key for k in path): v for path, v in
                    jax.tree_util.tree_flatten_with_path(r.cache_specs)[0]}
        port = list(_paths(c.cache_specs))
        assert len(port) == len(ref_flat)
        for full, keys, _ in port:
            t, ref_t = _get(c.cache_specs, full), ref_flat[keys]
            assert tuple(t.shape) == ref_t.shape, keys
            assert str(t.dtype).split(".")[-1] == str(ref_t.dtype)
            assert tuple(_get(c.cache_pspecs, full)) == tuple(
                _get(r.cache_pspecs, keys)), keys


def _ref_argument_bytes(arch, shape, multi_pod):
    """Sum of the reference's per-device shard bytes over the arguments of
    its dry-run program (params, ZeRO-1 state, batch / cache and tokens);
    the optimizer's int32 step is left out (the port keeps it on the
    host)."""
    cfg = jax_get_config(arch)
    mesh = AbstractMesh(*((( 2, 16, 16), ("pod", "data", "model"))
                          if multi_pod else ((16, 16), ("data", "model"))))
    rules = jreg.sharding_rules(cfg)
    ref = _ref_abstract(arch)
    vals, axes = jparams.split_tree(ref)
    cell = jreg.make_cell(arch, shape, multi_pod=multi_pod)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    pairs = list(zip(jax.tree.leaves(vals), jax.tree.leaves(
        jparams.pspec_tree(axes, rules), is_leaf=is_p)))
    if cell.kind == "train":
        opt = jax.eval_shape(jax_init_opt_state, ref)
        specs = jax_opt_state_pspecs(ref, rules, data_size=16)
        for k in ("master", "m", "v"):
            pairs += list(zip(jax.tree.leaves(opt[k]),
                              jax.tree.leaves(specs[k], is_leaf=is_p)))
    if cell.kind == "decode":
        pairs += list(zip(jax.tree.leaves(cell.cache_specs),
                          jax.tree.leaves(cell.cache_pspecs, is_leaf=is_p)))
    pairs += [(v, cell.input_pspecs[k]) for k, v in cell.inputs.items()]
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(v.shape)))
               * np.dtype(v.dtype).itemsize for v, s in pairs)


DENSE_CELLS = [(a, s) for a in DENSE_VLM for s in SHAPES
               if jreg.shape_applicable(jax_get_config(a), s)[0]]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", DENSE_CELLS)
def test_argument_bytes_match_reference(arch, shape, multi_pod):
    assert len(DENSE_CELLS) == 16
    assert dryrun.argument_bytes(get_config(arch), arch, shape, multi_pod) \
        == _ref_argument_bytes(arch, shape, multi_pod)


# ---------------------------------------------------------------------------
# a real 2 x 4 mesh of gloo processes
# ---------------------------------------------------------------------------
WORLD = 8
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.models import shardctx
    from repro_torch.models.params import (P, distribute_params, leaves,
                                           placements, shard_like, unflatten)
    from repro_torch.models.registry import build_model, sharding_rules
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import zero1_opt_state
    from repro_torch.train.train_step import compressed_psum


    def path_names(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from path_names(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from path_names(v, path + (str(i),))
        else:
            yield "/".join(path)

    torch.set_num_threads(1)
    rank, store_path, inputs, out = (int(sys.argv[1]), sys.argv[2],
                                     sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 8),
                            rank=rank, world_size=8)
    d = np.load(inputs)
    result = {}
    try:
        flat = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        g = torch.from_numpy(d["g_local"][rank])
        result["psum"] = compressed_psum({"w": g}, "data", mesh=flat)["w"]

        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for tag, flags in (("plain", {}), ("constrained", {
                "attn_batch_shard": True, "seq_shard_resid": True}),
                           ("heads_split", {"n_kv_heads": 2})):
            cfg = get_config("smollm_360m").reduced().replace(
                d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab_size=512, param_dtype="float32").replace(**flags)
            rules = dict(sharding_rules(cfg, tp=4))
            rules.update(heads="model", kv_heads=(
                None if tag == "heads_split" else "model"))
            model = build_model(cfg, device="cpu")
            like = model.init(torch.Generator().manual_seed(0))
            pre = "g/" if tag == "heads_split" else "p/"
            full = unflatten(like, [torch.from_numpy(d[pre + k])
                                    for k in path_names(like)])
            params = distribute_params(full, mesh, rules)
            opt = zero1_opt_state(full, mesh, rules)
            batch = {k: shard_like(torch.from_numpy(d[k]), mesh,
                                   placements(P("data", None), mesh))
                     for k in ("tokens", "labels")}
            step = make_train_step(model, OptConfig(warmup_steps=10))
            with shardctx.ctx(mesh, ("data",)):
                new, new_opt, met = step(params, opt, batch)
            for k in ("loss", "grad_norm"):
                v = met[k]
                result[f"{tag}_{k}"] = (v.full_tensor() if isinstance(
                    v, DTensor) else v)
            for i, t in enumerate(leaves(new)):
                result[f"{tag}_p{i}"] = t.full_tensor()
            for i, (t, p) in enumerate(zip(leaves(new), leaves(params))):
                assert tuple(t.placements) == tuple(p.placements), i
        if rank == 0:
            np.savez(out, **{k: np.asarray(v.detach().float())
                            for k, v in result.items()})
    finally:
        dist.destroy_process_group()
""")

REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.distributed import shard_map_compat
    from repro.train import compressed_psum

    g_local = np.load(sys.argv[1])["g_local"]
    mesh = Mesh(np.asarray(jax.devices()), ("data",))

    def body(g):
        return compressed_psum({"w": g[0]}, "data")["w"]

    out = jax.jit(shard_map_compat(body, mesh=mesh, in_specs=P("data"),
                                   out_specs=P()))(jnp.asarray(g_local))
    np.save(sys.argv[2], np.asarray(out))
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Inputs from numpy seed 0 and the reference's weights; the eight gloo
    ranks and the reference's eight-device compressed_psum run side by
    side, each process under its own timeout."""
    tmp = tmp_path_factory.mktemp("gloo")
    mini = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab_size=512, param_dtype="float32")
    # "p": 4 kv heads (plain, constrained); "g": 2 (heads_split)
    jcfgs = {k: jax_get_config("smollm_360m").reduced().replace(
        **mini).replace(n_kv_heads=n) for k, n in (("p", 4), ("g", 2))}
    cfgs = {k: get_config("smollm_360m").reduced().replace(**mini).replace(
        n_kv_heads=n) for k, n in (("p", 4), ("g", 2))}
    jps = {k: jreg.build_model(c).init(jax.random.PRNGKey(1))
           for k, c in jcfgs.items()}
    ports = {k: from_jax_params(jax.tree.map(
        np.asarray, jparams.split_tree(jps[k])[0]), cfgs[k], "cpu")
        for k in jps}
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 512, (8, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    g_local = rng.normal(size=(8, 256, 64)).astype(np.float32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, g_local=g_local, **batch,
             **{f"{k}/" + "/".join(map(str, full)): _get(port, full).numpy()
                for k, port in ports.items() for full, _, _ in _paths(port)})
    out, ref_out = tmp / "out.npz", tmp / "ref_psum.npy"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(tmp / "store"),
         str(inputs), str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REF_PSUM, str(inputs), str(ref_out)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs if log)
    jmet, want = {}, {}
    for k, jcfg in jcfgs.items():
        step = jax.jit(jax_make_train_step(jreg.build_model(jcfg),
                                           JaxOptConfig(warmup_steps=10)))
        jp2, _, jmet[k] = step(jps[k], jax_init_opt_state(jps[k]), {
            n: jax.numpy.asarray(v) for n, v in batch.items()})
        new = from_jax_params(jax.tree.map(
            np.asarray, jparams.split_tree(jp2)[0]), cfgs[k], "cpu")
        # the worker's leaves follow the port's init order
        order = [full for full, _, _ in _paths(registry.build_model(
            cfgs[k], device="meta").init(torch.Generator()))]
        want[k] = [_get(new, full).numpy() for full in order]
    return {"out": dict(np.load(out)), "ref_psum": np.load(ref_out),
            "g_local": g_local, "jmet": jmet, "want": want}


@pytest.mark.parametrize("tag", ["plain", "constrained", "heads_split"])
def test_two_by_four_train_step_matches_reference(gloo_run, tag):
    """One sharded train step on the 2 x 4 gloo mesh (ZeRO-1 over `data`;
    ``constrained``: attn_batch_shard and seq_shard_resid on;
    ``heads_split``: 2 kv heads, query heads on `model` and kv heads
    replicated, as policy B) against the reference's one-device step: loss
    within F32_LOSS_ATOL, the gradient norm within float32 summation (1e-5
    relative), every gathered new parameter within STEP_ATOL; each new
    parameter came back in its own placements (asserted in the worker)."""
    key = "g" if tag == "heads_split" else "p"
    out, jmet = gloo_run["out"], gloo_run["jmet"][key]
    assert abs(float(out[f"{tag}_loss"]) - float(jmet["loss"])) \
        < F32_LOSS_ATOL
    assert float(out[f"{tag}_grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    for i, w in enumerate(gloo_run["want"][key]):
        np.testing.assert_allclose(out[f"{tag}_p{i}"], w, rtol=0,
                                   atol=STEP_ATOL)


def test_compressed_psum_matches_reference(gloo_run):
    """compressed_psum on 8 gloo ranks: within 1e-6 of the reference's on
    8 host devices, within 0.02 relative of the exact mean."""
    got, ref = gloo_run["out"]["psum"], gloo_run["ref_psum"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    exact = gloo_run["g_local"].mean(axis=0)
    assert np.abs(got - exact).max() / np.abs(exact).max() < 0.02

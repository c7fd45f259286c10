"""Dry run: rank 0's program of every (arch x shape) cell on the production
meshes, on the meta device, with its per-device memory, FLOPs, bytes and
collectives.

Ports ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for a forced 512-device host mesh and reads XLA's memory and cost
analyses and the collectives of the partitioned HLO. Here one process
opens a ``fake`` world of 256 ranks (16 x 16) or 512 (2 x 16 x 16) as
rank 0 (``launch.mesh.fake_world``), lays the parameters, the ZeRO-1
optimizer state and the batch (train cells) or the cache (decode cells)
out as DTensors whose local shards are meta tensors, and runs rank 0's
program once at full depth: ``make_train_step`` (remat as configured),
``model.prefill``, or ``make_serve_step``'s decode. A dispatch mode
(``Recorder``) watches the local shard ops beneath DTensor and counts
  * FLOPs of the local ops only (the DTensor-level op carries the global
    shape; counting there would give the whole mesh's FLOPs);
  * bytes read and written by each local op that is not a view;
  * the result bytes of each functional collective, by kind and mesh axis;
  * the peak of live storage (arguments included, with the memory the
    card's kernels take inside themselves, ``scratch_bytes``, and cuBLAS's
    workspace from the first product on) and the argument bytes, the
    local shards' sum.
Nothing is allocated and no collective runs: the fake group's collectives
return buffers that are never written.

``--execute`` then runs the same program with its shards as real CUDA
tensors (collectives still the fake group's, so the values are not
results) and reports the card's peak allocated memory, the argument bytes,
the local FLOPs, the collective counts and the step's ms beside the dry
run's. Without CUDA it raises unless ``--device cpu`` is given.

The reference extrapolates costs from 1- and 2-unit compiles because XLA
costs a while loop's body once and full unrolls compile slowly; the port
executes every layer, so it has neither problem and counts at full depth.

This slice covers the dense and vlm families. The MoE, SSM, hybrid and
encoder-decoder configs raise ``ValueError`` (ROADMAP queue 1, item 5b).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape decode_32k --execute
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>[_<tag>].json.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     mesh_shape)
from repro_torch.models import shardctx
from repro_torch.models.params import (abstract_params, axes_for,
                                       distribute_params, leaves, placements,
                                       pspec_tree, shard_like, shard_shape,
                                       spec_leaves)
from repro_torch.models.registry import (batch_axes, build_model, make_cell,
                                         shape_applicable, sharding_rules)
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.train.optimizer import (OptConfig, opt_state_pspecs,
                                         zero1_opt_state)
from repro_torch.train.train_step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
FAMILIES = ("dense", "vlm")  # the families this slice carries through DTensor
ITEM5B = "ROADMAP queue 1, item 5b"

# functional collectives (DTensor's redistributions) -> the reference's kinds
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
# cuBLAS's workspace on an H100 (sm_90): PyTorch's default
# CUBLAS_WORKSPACE_CONFIG of 8 chunks of 4,096 KiB, taken from the caching
# allocator at a cuBLAS handle's first product and kept
# (tools/dryrun_probe.py --kernels). A thread has its own handle, and the
# card runs the backward pass on the autograd engine's device thread, so
# a train step holds two.
CUBLAS_WORKSPACE = 32 * 2 ** 20
_PRODUCTS = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def scratch_bytes(name: str, args, out) -> int:
    """Memory the card's kernel for op ``name`` allocates and frees inside
    itself, which the dispatcher never sees, from the meta inputs' layout,
    as ``tools/dryrun_probe.py --kernels`` reads it on the H100 (torch
    2.11): PyTorch's CUDA softmax copies a non-contiguous input to a
    contiguous one; its backward takes one output's bytes with a
    contiguous gradient and two with a transposed one (the product grad *
    output, laid out as grad, then its contiguous copy), and would copy a
    non-contiguous output too."""
    if name == "_softmax":
        return 0 if args[0].is_contiguous() else _nbytes(args[0])
    if name == "_softmax_backward_data":
        grad, output = args[0], args[1]
        return (_nbytes(out) * (1 if grad.is_contiguous() else 2)
                + (0 if output.is_contiguous() else _nbytes(output)))
    return 0


class Recorder(TorchDispatchMode):
    """Counts rank 0's local shard ops: FLOPs, bytes, collectives and live
    storage. DTensor-level ops are passed on (``NotImplemented``) and seen
    again as the local ops DTensor runs; the global-shape shadow ops of
    DTensor's sharding propagation run on fake tensors and are skipped."""

    def __init__(self, axis_of_group: dict[str, str]):
        super().__init__()
        self.axis_of_group = axis_of_group
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0})
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.workspaces: set[bool] = set()  # passes (backward?) holding one

    # -- live storage --------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        out = func(*args, **kwargs)
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in flat_in + flat_out):
            return out  # DTensor's sharding propagation, not rank 0's work
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in _COLLECTIVE_NS and name not in _COLLECTIVE_KIND:
            # wait_tensor, _wrap_tensor_autograd: their output is their
            # input on a device (their meta kernels allocate anew)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in _COLLECTIVE_NS:
            group = kwargs.get("group_name")
            if group is None:
                group = next(a for a in reversed(args) if isinstance(a, str))
            c = self.collectives[(_COLLECTIVE_KIND[name],
                                  self.axis_of_group.get(group, group))]
            c["count"] += 1
            c["bytes"] += sum(_nbytes(o) for o in flat_out)
        if not func.is_view:
            self.bytes += (sum(_nbytes(a) for a in flat_in)
                           + sum(_nbytes(o) for o in flat_out
                                 if not any(o is a for a in flat_in)))
        backward = torch._C._current_graph_task_id() != -1
        if name in _PRODUCTS and backward not in self.workspaces:
            self.workspaces.add(backward)
            self.live_bytes += CUBLAS_WORKSPACE
        for o in flat_out:
            self.track(o)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes
                              + scratch_bytes(name, args, out))
        return out

    def by_kind(self) -> dict[str, int]:
        out = {k: 0 for k in RL.KINDS}
        for (kind, _), c in self.collectives.items():
            out[kind] += c["bytes"]
        return out

    def counts(self) -> dict[str, int]:
        """Collective launches per ``kind@axis``."""
        return {f"{k}@{a}": c["count"]
                for (k, a), c in sorted(self.collectives.items())}

    def by_axis(self) -> dict[str, int]:
        """Collective result bytes per ``kind@axis``."""
        return {f"{k}@{a}": c["bytes"]
                for (k, a), c in sorted(self.collectives.items())}


def _axis_of_group(mesh) -> dict[str, str]:
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def check_family(cfg, arch: str) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{arch}: the {cfg.family} family's dry run is not ported yet "
            f"({ITEM5B}); this slice covers {', '.join(FAMILIES)}")


def _fill(t: torch.Tensor, high: int) -> None:
    """Give a CUDA input values a step can run on: small normals for
    floats, ids in [0, high) for integers."""
    if t.is_floating_point():
        t.normal_(0.0, 0.02)
    else:
        t.random_(0, high)


def mesh_sizes(multi_pod: bool) -> dict[str, int]:
    shape, names = mesh_shape(multi_pod)
    return dict(zip(names, shape))


def argument_specs(cfg, arch: str, shape: str, multi_pod: bool,
                   rules) -> list:
    """(global meta tensor, P) of every device argument of a cell's
    program: the parameters, then the ZeRO-1 float32 master and moments and
    the batch (train), the batch (prefill), or the cache, tokens and
    positions (decode). The optimizer's step count is a host integer
    here."""
    _, _, kind = SHAPES[shape]
    abstract = abstract_params(build_model(cfg, device="meta"))
    cell = make_cell(arch, shape, multi_pod=multi_pod, cfg=cfg)
    out = list(zip(leaves(abstract),
                   spec_leaves(pspec_tree(axes_for(abstract), rules))))
    if kind == "train":
        specs = opt_state_pspecs(abstract, rules,
                                 data_size=mesh_sizes(multi_pod)["data"])
        f32 = [torch.empty_like(t, dtype=torch.float32)
               for t in leaves(abstract)]
        out += 3 * list(zip(f32, spec_leaves(specs["master"])))
    if kind == "decode":
        out += list(zip(leaves(cell.cache_specs),
                        spec_leaves(cell.cache_pspecs)))
    out += [(t, cell.input_pspecs[k]) for k, t in cell.inputs.items()]
    return out


def argument_bytes(cfg, arch: str, shape: str, multi_pod: bool,
                   rules=None) -> int:
    """Per-device bytes of a cell's arguments, from the specs alone."""
    sizes = mesh_sizes(multi_pod)
    specs = argument_specs(cfg, arch, shape, multi_pod,
                           rules or sharding_rules(cfg))
    return sum(t.element_size() * math.prod(shard_shape(t.shape, p, sizes))
               for t, p in specs)


def build_program(cfg, arch: str, shape: str, mesh, multi_pod: bool, rules,
                  device: str = "meta"):
    """Rank 0's program of one cell: (kind, fn, args), every tensor of
    ``args`` a DTensor whose local shard is on ``device`` (meta: nothing
    allocated; elsewhere filled with values a step can run on)."""
    seq, batch, kind = SHAPES[shape]
    model = build_model(cfg, device=device)
    abstract = abstract_params(build_model(cfg, device="meta"))
    cell = make_cell(arch, shape, multi_pod=multi_pod, cfg=cfg)
    params = distribute_params(abstract, mesh, rules, device=device)

    def shard_tree(tree, specs):
        if isinstance(tree, dict):
            return {k: shard_tree(v, specs[k]) for k, v in tree.items()}
        return shard_like(tree, mesh, placements(specs, mesh), device)

    inputs = shard_tree(cell.inputs, cell.input_pspecs)
    if kind == "train":
        opt = zero1_opt_state(abstract, mesh, rules, device=device)
        step = make_train_step(model, OptConfig(), grad_accum=cfg.grad_accum)
        fn, args = step, (params, opt, inputs)
    elif kind == "prefill":
        fn, args = model.prefill, (params, inputs)
    else:
        cache = shard_tree(cell.cache_specs, cell.cache_pspecs)
        fn = make_serve_step(model)
        args = (params, cache, inputs["tokens"], inputs["pos"])
    if device != "meta":
        for t in leaves(args):
            if isinstance(t, DTensor):
                last = kind == "decode" and t is args[-1]
                _fill(t._local_tensor, seq if last else cfg.vocab_size)
    return kind, fn, args


def _shards(args) -> list:
    """The local shards of the DTensors in ``args``."""
    return [t._local_tensor for t in leaves(args) if isinstance(t, DTensor)]


def arg_bytes(args) -> int:
    return sum(_nbytes(t) for t in _shards(args))


def run_program(kind, fn, args, mesh, multi_pod: bool, record: bool = True):
    """Run ``fn(*args)`` under the mesh's sharding context (no grad outside
    a train step) -> (Recorder or None, seconds)."""
    rec = Recorder(_axis_of_group(mesh)) if record else None
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    t0 = time.perf_counter()
    with shardctx.ctx(mesh, batch_axes(multi_pod)), grad, \
            (rec if rec is not None else contextlib.nullcontext()):
        if rec is not None:
            for t in _shards(args):
                rec.track(t)
        out = fn(*args)
        del out
    return rec, time.perf_counter() - t0


def default_mesh_device() -> str:
    """``cuda`` where this torch has CUDA, else ``cpu``. The two programs
    differ in one place: on a ``cpu`` mesh DTensor turns an all-to-all
    into an all-gather and a local chunk. A CPU-only build cannot use a
    ``cuda`` mesh: DTensor's sharding propagation makes fake CUDA tensors,
    and some of their ops need CUDA."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             rules_override=None, verbose: bool = True, cfg_override=None,
             tag: str = "", execute: bool = False,
             device: str = "cuda") -> dict:
    """Dry-run one cell (and with ``execute`` run it on ``device`` too);
    returns the result record, also written under ``out_dir``. The mesh's
    device type, ``default_mesh_device()``, is kept in the record."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    check_family(cfg, arch)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
           "ts": time.time()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return _save(rec, out_dir)
    if execute and torch.device(device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--execute runs on cuda and no CUDA device is "
                           "available; pass --device cpu to run on the CPU")

    seq, batch, kind = SHAPES[shape]
    rules = rules_override or sharding_rules(cfg)
    world = 512 if multi_pod else 256
    mesh_device = default_mesh_device()
    rec["mesh_device"] = mesh_device
    with fake_world(world):
        mesh = make_production_mesh(multi_pod, device_type=mesh_device)
        t0 = time.perf_counter()
        kind, fn, args = build_program(cfg, arch, shape, mesh, multi_pod,
                                       rules)
        t_build = time.perf_counter() - t0
        args_b = arg_bytes(args)
        want = argument_bytes(cfg, arch, shape, multi_pod, rules)
        if args_b != want:
            raise RuntimeError(f"{arch} x {shape}: shards of {args_b} "
                                 f"bytes, the specs give {want}")
        r, t_run = run_program(kind, fn, args, mesh, multi_pod)
        del fn, args
        measured = (execute_program(cfg, arch, shape, mesh, multi_pod, rules,
                                    device) if execute else None)

    rl = RL.Roofline(float(r.flops), float(r.bytes), r.by_kind())
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mf = RL.model_flops(cfg, tokens, train=(kind == "train"))
    counts = cfg.param_counts()
    rec.update(
        status="ok", kind=kind, chips=world,
        lower_s=round(t_build, 2), compile_s=round(t_run, 2),
        tokens_per_step=tokens,
        params_total=counts["total"], params_active=counts["active"],
        model_flops=mf,
        model_flops_per_device=mf / world,
        useful_flops_ratio=(mf / world) / r.flops if r.flops else None,
        memory_analysis={
            "argument_size_in_bytes": args_b,
            "temp_size_in_bytes": r.peak_bytes - args_b,
            "peak_size_in_bytes": r.peak_bytes,
        },
        cost_method="full-depth execution on the meta device",
        collective_counts=r.counts(),
        collective_bytes_by_axis=r.by_axis(),
        **rl.summary(),
    )
    if measured is not None:
        rec["execute"] = measured
    if verbose:
        print(f"[{arch} x {shape} x {mesh_name}] kind={kind} "
              f"run={t_run:.1f}s flops/dev={r.flops:.3e} "
              f"useful={rec['useful_flops_ratio'] or 0:.2f} "
              f"peak={r.peak_bytes / 1e9:.2f}GB dominant={rl.dominant} "
              f"(c={rl.compute_s*1e3:.2f}ms m={rl.memory_s*1e3:.2f}ms "
              f"coll={rl.collective_s*1e3:.2f}ms)", flush=True)
        if measured is not None:
            peak = measured["max_memory_allocated"]
            print(f"  executed on {measured['device']}: peak="
                  + (f"{peak / 1e9:.2f}GB" if peak is not None
                     else "not measured")
                  + f" step={measured['step_ms']:.1f}ms", flush=True)
    return _save(rec, out_dir)


def execute_program(cfg, arch, shape, mesh, multi_pod, rules,
                    device: str) -> dict:
    """Rank 0's program with real shards on ``device``: one recorded run
    (counts), then one timed run from a reset peak (memory, ms)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind, fn, args = build_program(cfg, arch, shape, mesh, multi_pod, rules,
                                   device=device)
    args_b = arg_bytes(args)
    if cuda:
        # the program's own cuBLAS workspaces only: those of earlier work
        # in this process are freed, once it is done
        torch.cuda.synchronize(dev)  # mdrqlint: disable=host-sync
        torch._C._cuda_clearCublasWorkspaces()
    r, _ = run_program(kind, fn, args, mesh, multi_pod)
    if cuda:
        # a measurement: the step's work done, then the peak from here
        torch.cuda.synchronize(dev)  # mdrqlint: disable=host-sync
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_program(kind, fn, args, mesh, multi_pod, record=False)
    if cuda:
        # the step's time ends when the card has done its work
        torch.cuda.synchronize(dev)  # mdrqlint: disable=host-sync
    secs = time.perf_counter() - t0
    return {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "argument_size_in_bytes": args_b,
            "flops_per_device": float(r.flops),
            "collective_counts": r.counts(),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None),
            "step_ms": secs * 1e3}


def _save(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{rec.get('tag', '')}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--execute", action="store_true",
                    help="also run rank 0's program with real shards")
    ap.add_argument("--device", default="cuda",
                    help="device of --execute (cuda; cpu only if asked)")
    args = ap.parse_args(argv)
    if args.execute and (args.all or args.arch is None or args.shape is None):
        ap.error("--execute runs one cell: give --arch and --shape")

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    ported = [a for a in archs if get_config(a).family in FAMILIES]
    deferred = [a for a in archs if a not in ported]
    if deferred and (args.all or args.arch is None):
        print(f"deferred ({ITEM5B}): {', '.join(deferred)}", flush=True)
        archs = ported
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    print(f"mesh device type: {default_mesh_device()}", flush=True)
    failures = 0
    for a, s, mp in cells:
        try:
            run_cell(a, s, mp, args.out, execute=args.execute,
                     device=args.device)
        except Exception:
            failures += 1
            print(f"FAILED [{a} x {s} x {_mesh_name(mp)}]", flush=True)
            traceback.print_exc()
    print(f"dry-run complete: {len(cells) - failures}/{len(cells)} cells ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

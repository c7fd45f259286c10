"""Where the card's allocations part from the dry run's live storage.

  python3 tools/dryrun_probe.py --arch smollm_360m --shape train_4k

Runs one cell of ``repro_torch.launch.dryrun`` with real CUDA shards under
a recorder that, after every local op, compares
``torch.cuda.memory_allocated()`` with the recorder's live storage, and
prints the ops at which the gap between the two grew most, the two peaks,
and the ops that allocated most inside themselves (memory the dispatcher
never sees: the peak within the op less what it left allocated).
``--peaks`` instead prints the allocated peak of the program run bare,
under a dispatch mode that only passes each op on, and bare again.
``--kernels`` prints what the first products of a process, forward and
backward, keep allocated (cuBLAS's workspaces) and, for the softmax
forward and backward over contiguous and transposed float32 inputs, what
each allocates inside itself beside ``dryrun.scratch_bytes``'s count for
the same meta inputs.
Needs the card; prints no contract line.
"""
import argparse
import collections
import contextlib
import os
import sys

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.models.registry import sharding_rules  # noqa: E402


class GapRecorder(dryrun.Recorder):
    def __init__(self, *a):
        super().__init__(*a)
        self.offset = None
        self.gap = 0
        self.grew = collections.Counter()
        self.peak_alloc = 0
        self.transient = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        torch.cuda.reset_peak_memory_stats()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        alloc = torch.cuda.memory_allocated()
        inside = torch.cuda.max_memory_allocated()
        self.peak_alloc = max(self.peak_alloc, inside)
        shapes = tuple(tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor))
        key = f"{func} {shapes}"
        self.transient[key] = max(self.transient[key], inside - alloc)
        gap = alloc - self.live_bytes - self.offset
        if gap > self.gap:
            self.grew[str(func)] += gap - self.gap
        self.gap = gap
        return out


class PassThrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **(kwargs or {}))


def peaks(cfg, arch, shape) -> None:
    """The allocated peak of the cell's program run bare, under a mode that
    only passes each op on, and bare again."""
    from repro_torch.models import shardctx
    from repro_torch.models.registry import batch_axes
    with fake_world(256):
        mesh = make_production_mesh(False)
        kind, fn, fargs = dryrun.build_program(
            cfg, arch, shape, mesh, False, sharding_rules(cfg),
            device="cuda")
        for name in ("bare", "pass-through", "bare"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grad = torch.enable_grad() if kind == "train" else torch.no_grad()
            mode = PassThrough() if name == "pass-through" else \
                contextlib.nullcontext()
            with shardctx.ctx(mesh, batch_axes(False)), grad, mode:
                out = fn(*fargs)
                del out
            torch.cuda.synchronize()
            print(f"{name}: allocated peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
                  f"(CUDA_LAUNCH_BLOCKING={os.environ.get('CUDA_LAUNCH_BLOCKING', '0')})",
                  flush=True)


def _inside(fn):
    """(result, bytes allocated and freed inside ``fn()``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - \
        torch.cuda.memory_allocated()


def kernels() -> None:
    """cuBLAS's workspace, then the softmax kernels' scratch by layout."""
    print(f"CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG', '(unset)')}")
    bf = torch.randn(512, 512, device="cuda", dtype=torch.bfloat16)
    f32 = bf.float()
    bias = torch.randn(512, device="cuda", dtype=torch.bfloat16)
    for name, fn in (("bf16 mm", lambda: bf @ bf),
                     ("float32 mm", lambda: f32 @ f32),
                     ("bf16 bmm", lambda: bf[None] @ bf[None]),
                     ("bf16 addmm (cublasLt)",
                      lambda: torch.addmm(bias, bf, bf))):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - before - out.numel() * \
            out.element_size()
        print(f"  first {name}: {kept} bytes kept beside its output "
              f"(dryrun.CUBLAS_WORKSPACE = {dryrun.CUBLAS_WORKSPACE})")
        del out
    w = torch.randn(512, 512, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    (bf @ w).float().sum().backward()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before - w.grad.nbytes
    print(f"  first backward product (the autograd engine's thread): {kept} "
          f"bytes kept beside the gradient")
    # (4, 2, 2, 2048, 4096) float32, 1.07 GB; transposed as the scores'
    # gradient in the program: dims 2 and 3 of a contiguous (4, 2, 2048,
    # 2, 4096)
    shape = (4, 2, 2, 2048, 4096)

    def make(layout):
        if layout == "contiguous":
            return torch.randn(shape, device="cuda")
        return torch.randn(4, 2, 2048, 2, 4096, device="cuda").transpose(2, 3)

    for x_layout in ("contiguous", "transposed"):
        x = make(x_layout)
        y, inside = _inside(lambda: torch.ops.aten._softmax(x, -1, False))
        want = dryrun.scratch_bytes("_softmax", (x.to("meta"), -1, False),
                                    y.to("meta"))
        print(f"  _softmax, input {x_layout}: {inside} bytes inside, "
              f"{inside / y.nbytes:.3f} x the output; scratch_bytes {want}")
        for g_layout in ("contiguous", "transposed"):
            g = make(g_layout)
            args = (g, y, -1, torch.float32)
            gi, inside = _inside(
                lambda: torch.ops.aten._softmax_backward_data(*args))
            want = dryrun.scratch_bytes(
                "_softmax_backward_data",
                tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                      for a in args), gi.to("meta"))
            print(f"  _softmax_backward_data, grad {g_layout}, output "
                  f"contiguous: {inside} bytes inside, "
                  f"{inside / gi.nbytes:.3f} x the output; scratch_bytes "
                  f"{want}", flush=True)
            del g, gi
        del x, y


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--peaks", action="store_true",
                    help="only the bare and pass-through peaks")
    ap.add_argument("--kernels", action="store_true",
                    help="cuBLAS's workspace and the softmax scratch")
    args = ap.parse_args()
    if args.kernels:
        kernels()
        return 0
    if args.peaks:
        peaks(get_config(args.arch), args.arch, args.shape)
        return 0
    cfg = get_config(args.arch)
    with fake_world(256):
        mesh = make_production_mesh(False)
        kind, fn, fargs = dryrun.build_program(
            cfg, args.arch, args.shape, mesh, False, sharding_rules(cfg),
            device="cuda")
        torch.cuda.synchronize()
        rec = GapRecorder(dryrun._axis_of_group(mesh))
        for t in dryrun._shards(fargs):
            rec.track(t)
        rec.offset = torch.cuda.memory_allocated() - rec.live_bytes
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        from repro_torch.models import shardctx
        from repro_torch.models.registry import batch_axes
        with shardctx.ctx(mesh, batch_axes(False)), grad, rec:
            out = fn(*fargs)
            del out
        torch.cuda.synchronize()
    print(f"offset {rec.offset / 1e9:.3f} GB; live peak "
          f"{rec.peak_bytes / 1e9:.3f} GB; allocated peak "
          f"{rec.peak_alloc / 1e9:.3f} GB; final gap {rec.gap / 1e9:.3f} GB")
    for op, b in rec.grew.most_common(15):
        print(f"  gap grew {b / 1e9:8.3f} GB at {op}")
    for op, b in rec.transient.most_common(10):
        print(f"  allocated and freed inside the op: {b / 1e9:8.3f} GB at "
              f"{op}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

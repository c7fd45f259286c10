#!/usr/bin/env python3
"""Where a full-width train step's time goes, on one card.

    python3 tools/train_probe.py [--arch smollm_360m] [--batch 8] [--seq 512]
                                 [--remat full,none] [--steps 6]
                                 [--device cuda:0] [--reduced]

Builds the model at full width (random bf16 weights, ``torch.Generator``
seed 0) on cuda:0 and one batch of the MDRQ-filtered pipeline (step 0,
numpy seed 0), then for each ``--remat`` setting runs ``--steps`` train
steps of ``train.make_train_step`` (AdamW, the Trainer's path without the
checkpoint) and prints, per setting:

- the first step split into its parts, each ended by a synchronize: the
  forward and loss, the backward (``torch.autograd.grad``), the optimizer
  update (``adamw_update``);
- the same split of a warm step, and the host-clock ms of warm whole steps
  (median);
- a ``torch.profiler`` window over two warm steps: device busy ms per step
  (the union of kernel intervals), device kernels per step, the idle share
  of the step, and the top device ops by time.

``--device cpu --reduced`` rehearses the control flow on the CPU (no
device events there). It prints no contract line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def split_step(model, params, opt, batch, opt_cfg) -> tuple[dict, tuple]:
    """One step in three synchronized parts -> (ms of each, new state)."""
    import torch
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.train.optimizer import adamw_update
    t0 = _sync()
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    total, _ = model.loss_fn(unflatten(params, live), batch)
    t1 = _sync()
    grads = torch.autograd.grad(total, live)
    t2 = _sync()
    p2, o2, _ = adamw_update(params, unflatten(params, grads), opt, opt_cfg)
    t3 = _sync()
    ms = {"forward_loss": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3,
          "optimizer": (t3 - t2) * 1e3}
    return ms, (p2, o2)


def busy_ms(events) -> float:
    """Union of the device kernels' intervals, ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile(step, state, batch, n: int = 2) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    params, opt = state
    t0 = _sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            params, opt, _ = step(params, opt, batch)
        _sync()
    wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels) / n
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "device_kernels_per_step": len(kernels) / n,
            "idle_share": 1 - busy / wall if wall else None,
            "top_device_ms_per_step": [(k[:90], v / 1e3 / n) for k, v in top]}


def main(argv=None) -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, FilteredTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train import OptConfig, init_opt_state, make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--remat", default="full,none")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    base = get_config(args.arch)
    if args.reduced:
        base = base.reduced()
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=base.vocab_size, seq_len=args.seq,
        global_batch=args.batch, n_pool=16384, seed=0), device=dev)
    batch = {k: ops.upload(v, dev) for k, v in pipe.batch(0).items()}
    opt_cfg = OptConfig(warmup_steps=5, decay_steps=100)
    for remat in args.remat.split(","):
        cfg = base.replace(remat=remat)
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        opt = init_opt_state(params)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        first, state = split_step(model, params, opt, batch, opt_cfg)
        step = make_train_step(model, opt_cfg)
        times = []
        for _ in range(args.steps):
            t0 = _sync()
            p, o, _ = step(*state, batch)
            state = (p, o)
            times.append((_sync() - t0) * 1e3)
        warm, state = split_step(model, *state, batch, opt_cfg)
        prof = profile(step, state, batch)
        print(json.dumps({
            "arch": cfg.name, "remat": remat, "batch": args.batch,
            "seq": args.seq, "first_step_ms": first, "warm_step_split_ms":
            warm, "warm_step_ms": times, "warm_step_ms_median":
            float(np.median(times)), "peak_gb":
            torch.cuda.max_memory_allocated() / 1e9, **prof}), flush=True)
        del model, params, opt, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

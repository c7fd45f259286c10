#!/usr/bin/env python3
"""How often a short torch.profiler window loses its device events, by the
way the window is taken.

    python3 tools/profiler_probe.py [--kernel add|kv] [--windows N]
        [--variants bare,pad] [--reps 10] [--load-s S] [--timed]
        [--out FILE.json]

Each window is ``chip_smoke.profile_window`` over ``--reps`` calls of one
kernel: ``add``, ``x.add_(1)`` on 4,096 float32 values (a few microseconds
each); ``kv``, ``kv_visit_attention`` at ``chip_smoke.py``'s long-context
shape (``chip_smoke.decode_kv_case``, B = 4 at 32,768 slots, 16 of 64
blocks of 512; the kernels are built first). The variants:

- ``bare``: a window without margins (pad 0);
- ``pad``: a window padded with ``chip_smoke.PROFILE_PAD_S`` of quiet at
  each edge;
- ``prime``: a padded window of one call, thrown away, then a padded
  window, which is the one read;
- ``unscheduled``: one ``profile()`` session without a schedule, padded
  the same, over ``--reps`` calls.

The variants take turns, in the order given and then reversed,
``--windows`` windows each. Before each window the card multiplies bf16
8192 x 8192 matrices for ``--load-s`` seconds, as the phases before a
check keep it busy; with ``--timed`` the kernel is then also timed without
the profiler as ``chip_smoke.kv_visit_timing`` does between its windows
(``time_ms``, ``host_us``). Per variant it prints the windows whose device
events numbered the calls, fewer (incomplete), and more, the host-side
launch events each window kept, and the lead of the window's first device
event over its first launch on the host clock (negative: the device
timestamp reads earlier than the launch). Prints the card's name and power
limit first; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def lead_us(events, dev) -> float | None:
    """First device event's start minus the first launch's start, in us."""
    launches = [e.time_range.start for e in events
                if e.name in LAUNCH_NAMES]
    if not dev or not launches:
        return None
    return min(e.time_range.start for e in dev) - min(launches)


def unscheduled_window(fn, reps: int, pad_s: float) -> list:
    """One ``profile()`` session without a schedule over ``reps`` calls,
    padded at each edge -> its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return list(prof.events())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("add", "kv"), default="add")
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--variants", default="bare,pad")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--load-s", type=float, default=0.5)
    ap.add_argument("--timed", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    if args.kernel == "kv":
        from repro_torch.kernels import _build, kv_visit
        _build.build()
        q, kb, vb, ids, pos = cs.decode_kv_case(
            [cs.LONG_SLOTS - 2 - 64 * b for b in range(cs.LONG_B)],
            cs.LONG_SLOTS, cs.LONG_BLOCK, cs.LONG_PRUNE)

        def fn():
            return kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    else:
        x = torch.zeros(4096, device="cuda")

        def fn():
            return x.add_(1)
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

    def load():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.load_s:
            a @ a
            torch.cuda.synchronize()
        if args.timed:
            cs.time_ms(fn)
            cs.host_us(fn)

    def window(variant: str) -> list:
        if variant == "bare":
            return cs.profile_window(fn, args.reps, 0.0)
        if variant == "prime":
            cs.profile_window(fn, 1)
        if variant == "unscheduled":
            return unscheduled_window(fn, args.reps, cs.PROFILE_PAD_S)
        return cs.profile_window(fn, args.reps)

    variants = args.variants.split(",")
    seen = {v: {"complete": 0, "incomplete": 0, "more": 0, "kept": [],
                "launch_events": [], "lead_us": []} for v in variants}
    fn()
    torch.cuda.synchronize()
    for w in range(args.windows):
        for variant in (variants if w % 2 == 0 else variants[::-1]):
            load()
            events = window(variant)
            dev = cs.device_events(events)
            s = seen[variant]
            n = len(dev)
            s["kept"].append(n)
            s["launch_events"].append(
                sum(e.name in LAUNCH_NAMES for e in events))
            s["complete" if n == args.reps else
              "incomplete" if n < args.reps else "more"] += 1
            lead = lead_us(events, dev)
            if lead is not None:
                s["lead_us"].append(lead)
    for variant, s in seen.items():
        leads = sorted(s["lead_us"])
        lead_txt = (f"lead of the first device event over the first launch "
                    f"min {leads[0]:.1f} median {leads[len(leads) // 2]:.1f}"
                    f" max {leads[-1]:.1f} us over {len(leads)} windows"
                    if leads else "no window kept a device event and a "
                                  "launch")
        print(f"{args.kernel} {variant}: {args.windows} windows of "
              f"{args.reps} calls: {s['complete']} complete, "
              f"{s['incomplete']} incomplete (kept {sorted(set(s['kept']))}),"
              f" {s['more']} with more events than calls; launch events "
              f"kept {sorted(set(s['launch_events']))}; {lead_txt}",
              flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"device": cs.nvidia_smi_line(), "kernel": args.kernel,
             "reps": args.reps, "load_s": args.load_s, "timed": args.timed,
             "variants": seen}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The LM phases alone, and the decode step time of a checkout.

    python3 tools/lm_probe.py phases
    python3 tools/lm_probe.py train [--arch ARCH ...]
    python3 tools/lm_probe.py step --root DIR [--layers N]

``phases`` builds the kernels and runs ``chip_smoke.py``'s ``lm`` and
``lm_families`` phases (its own functions, from the ``chip_smoke.py`` beside
this tool), then prints their kernel rows as JSON. It is for iterating on
those phases without the MDRQ phases before them; it prints no contract
line, so a run of it is never mistaken for a run of ``chip_smoke.py``.
``train`` does the same for the train phase's parts of the other families
(``train_families_parts``: MoE, the encoder-decoder, Mamba-2 and
RecurrentGemma) and the LM examples (``lm_examples_part``), and prints
their kernel launches; ``--arch`` runs only the named families' parts and
no examples.

``step`` imports ``repro_torch`` from ``DIR/src`` (a checkout of this
repository, for example the parent commit unpacked with ``git archive``),
builds its kernels and times Qwen3-8B at full width and ``N`` layers
(default 12; random bf16 weights, seed 0; ``kv_block_prune=4``,
``kv_block_size=32``) on one card:

- served: ``chip_smoke.py``'s multi-block request set (8 requests, numpy
  seed 1, prompts of 40-120 tokens, 24 new, all admitted) through
  ``BatchServer(slots=4, max_len=1024)``, three times on fresh servers,
  host-clock ms per decode step of each;
- direct: ``model.decode_step`` on one B = 4 cache at positions 100-103,
  50 warm steps, host-clock ms per step (outside ``BatchServer``, so both
  checkouts step in the same autograd mode).

Every line names the checkout. To compare two checkouts, run them in one
call in the order A, B, B, A. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

LM_ARCH = "qwen3_8b"
SLOTS, MAX_LEN = 4, 1024
REQUESTS, PROMPT, NEW = 8, (40, 121), 24
SERVES, DIRECT_STEPS = 3, 50


def phases() -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("lm_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    with cs.phase("build"):
        _build.build()
        cs.kv_build_check()
    rows = []
    with cs.phase("lm"):
        rows.append(cs.lm_phase())
    with cs.phase("lm_families"):
        cs.lm_families_phase(rows)
    print(json.dumps({"kernels": rows}))
    return 0


def train(archs: list[str] | None = None) -> int:
    sys.path.insert(0, str(HERE))
    import shutil
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("lm_probe: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(cs.nvidia_smi_line(), flush=True)
    with cs.phase("build"):
        _build.build()
    if archs:
        known = [a for a, _ in cs.TRAIN_FAMILIES]
        if set(archs) - set(known):
            print(f"lm_probe: --arch takes {known}", file=sys.stderr)
            return 2
        cs.TRAIN_FAMILIES = tuple(f for f in cs.TRAIN_FAMILIES
                                  if f[0] in archs)
    launches = {}
    with cs.phase("train:families"):
        shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)
        try:
            launches["train"] = cs.train_families_parts()
        finally:
            shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)
    if not archs:
        with cs.phase("examples:lm"):
            launches["examples"] = cs.lm_examples_part()
    print(json.dumps({"launches": launches}))
    return 0


def step(root: Path, layers: int) -> int:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model
    from repro_torch.serve import BatchServer, Request, admission_query

    if not torch.cuda.is_available():
        print("lm_probe: needs a CUDA device", file=sys.stderr)
        return 2
    label = f"{root.name} ({root})"
    _build.build()
    cfg = get_config(LM_ARCH).replace(n_layers=layers, kv_block_prune=4,
                                      kv_block_size=32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))

    def requests():
        rng = np.random.default_rng(1)
        out = []
        for i in range(REQUESTS):
            toks = rng.integers(0, cfg.vocab_size, int(rng.integers(*PROMPT)))
            out.append(Request(rid=i, prompt=toks.astype(np.int32),
                               max_new=NEW,
                               features=np.array([0.5, toks.size, 100.0, 0.5],
                                                 np.float32)))
        return out

    served = []
    for _ in range(SERVES):
        srv = BatchServer(model, params, slots=SLOTS, max_len=MAX_LEN)
        inner, calls = srv.step_fn, [0]

        def counted(*a, inner=inner, calls=calls):
            calls[0] += 1
            return inner(*a)
        srv.step_fn = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.serve(requests(), admission_query())
        torch.cuda.synchronize()
        served.append((time.perf_counter() - t0) / calls[0] * 1e3)
        del srv

    cache = model.init_cache(SLOTS, MAX_LEN, model.dtype)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.arange(100, 100 + SLOTS, dtype=torch.int32, device="cuda")
    for _ in range(3):
        model.decode_step(params, cache, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIRECT_STEPS):
        model.decode_step(params, cache, tok, pos)
    torch.cuda.synchronize()
    direct = (time.perf_counter() - t0) / DIRECT_STEPS * 1e3
    print(f"{label}: Qwen3-8B full width, {layers} layers: served ms/step "
          + ", ".join(f"{ms:.2f}" for ms in served)
          + f" ({calls[0]} steps each); direct decode_step ms/step "
          f"{direct:.2f}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("phases")
    tr = sub.add_parser("train")
    tr.add_argument("--arch", nargs="+", default=None)
    st = sub.add_parser("step")
    st.add_argument("--root", type=Path, required=True)
    st.add_argument("--layers", type=int, default=12)
    args = ap.parse_args(argv)
    if args.mode == "phases":
        return phases()
    if args.mode == "train":
        return train(args.arch)
    return step(args.root.resolve(), args.layers)


if __name__ == "__main__":
    sys.exit(main())

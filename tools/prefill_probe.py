#!/usr/bin/env python3
"""How far prefill and decode drift apart in bf16, and which drifts.

    python3 tools/prefill_probe.py [--arch mamba2_780m ...]
                                   [--depths 1,8,24,48]

For each architecture, trains the model as ``chip_smoke.py``'s train phase
does (``train_family_part``: published widths, the depth of its
``TRAIN_FAMILIES`` entry, random bf16 weights, seed 0,
``TRAIN_FAMILY_STEPS`` Trainer steps of 8 x 512 on the MDRQ-filtered
pipeline), then on ``chip_smoke.py``'s prefill prompt (B = 2, 64 tokens,
seed 0) prints, for the first n layers of the trained stack (n from
``--depths``; a hybrid's depth counts whole groups and then tail layers):

- bf16 prefill against bf16 decode (``chip_smoke.train_prefill_part``'s
  reading, through its ``prefill_and_decode``: max |diff| of the
  last-token logits);
- each bf16 path against the same path on a float32 copy of the weights
  (the float32 prefill against the float32 decode too), so the reading
  says which of the two bf16 paths carries the drift;
- the bf16 readings again with cuBLAS's reduced-precision bf16 reductions
  off (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
  = False``).

It also plants, one at a time and in memory only, a fault in the sequence
form that the prefill runs and the decode does not (``FAULTS``: the chunked SSD's intra-chunk decay for Mamba-2, the RG-LRU
scan's combine for RecurrentGemma) and prints what each arm of
``chip_smoke.train_prefill_part`` would read: the faulted bf16 prefill
against the sound bf16 decode and against the sound float32 prefill, and
the faulted float32 prefill against the sound float32 decode. These are
the readings that a limit on those arms must stay below.

It prints no contract line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def reduced_reductions(allowed: bool):
    import torch
    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = before


def truncated(cfg, params, depth: int):
    """(config, parameters) of the stack's first ``depth`` layers."""
    out = dict(params)
    if cfg.family == "hybrid":
        groups, tail = divmod(cfg.n_layers, 3)
        g = min(groups, depth)
        t = min(tail, depth - g)
        out["groups"] = params["groups"][:g]
        if t > 0:
            out["tail"] = params["tail"][:t]
        else:
            out.pop("tail", None)
        return cfg.replace(n_layers=3 * g + max(t, 0)), out
    out["layers"] = params["layers"][:depth]
    return cfg.replace(n_layers=depth), out


def _segsum_extra_step(real):
    """Every intra-chunk decay one step too long: exp(a_j + ... + a_i) in
    place of exp(a_{j+1} + ... + a_i)."""
    def segsum(x):
        return real(x) + x[..., None, :]
    return segsum


def _segsum_no_diagonal(real):
    """Each position's own input left out of the intra-chunk product."""
    import torch

    def segsum(x):
        t = x.shape[-1]
        eye = torch.eye(t, dtype=torch.bool, device=x.device)
        return real(x).masked_fill(eye, -torch.inf)
    return segsum


def _combine_swapped(real):
    """The scan's combine with its operands in the other order."""
    def combine(c1, c2):
        return real(c2, c1)
    return combine


# family -> (name, module, attribute, fault); each replaces a function that
# only the sequence form (prefill) calls
FAULTS = {
    "ssm": [("ssd_extra_decay_step", "ssm", "_segsum", _segsum_extra_step),
            ("ssd_no_diagonal", "ssm", "_segsum", _segsum_no_diagonal)],
    "hybrid": [("scan_combine_swapped", "rglru", "_combine",
                _combine_swapped)],
}


@contextlib.contextmanager
def planted(module: str, attr: str, fault):
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{module}")
    real = getattr(mod, attr)
    setattr(mod, attr, fault(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def fault_readings(cfg, model, model32, p, p32, toks, dec, pre32,
                   dec32) -> dict:
    """{fault: its three readings} for ``cfg``'s family."""
    import torch
    out = {}
    for name, module, attr, fault in FAULTS.get(cfg.family, []):
        with planted(module, attr, fault), torch.inference_mode():
            pre_bad, _ = model.prefill(p, {"tokens": toks})
            pre32_bad, _ = model32.prefill(p32, {"tokens": toks})
        out[name] = {
            "bf16_prefill_vs_bf16_decode": float((pre_bad - dec).abs().amax()),
            "bf16_prefill_vs_f32_prefill": float(
                (pre_bad - pre32).abs().amax()),
            "f32_prefill_vs_f32_decode": float(
                (pre32_bad - dec32).abs().amax())}
    return out


def readings(tr, depths: list[int]) -> list[dict]:
    import torch
    import chip_smoke as cs
    from repro_torch.models.params import map_tree
    from repro_torch.models.registry import build_model
    cfg = tr.model.cfg
    gen = torch.Generator(device=cs.TRAIN_DEVICE).manual_seed(cs.SEED)
    toks = torch.randint(0, cfg.vocab_size, (cs.PREFILL_B, cs.PREFILL_LEN),
                         generator=gen, device=cs.TRAIN_DEVICE,
                         dtype=torch.int32)
    rows = []
    for depth in depths:
        c, p = truncated(cfg, tr.params, depth)
        model = build_model(c, device=cs.TRAIN_DEVICE)
        model32 = build_model(c.replace(param_dtype="float32"),
                              device=cs.TRAIN_DEVICE)
        p32 = map_tree(p, lambda t: t.float())
        pre, dec = cs.prefill_and_decode(model, p, toks)
        pre32, dec32 = cs.prefill_and_decode(model32, p32, toks)
        with reduced_reductions(False):
            pre_f, dec_f = cs.prefill_and_decode(model, p, toks)

        def err(a, b):
            return float((a - b).abs().amax())
        rows.append({
            "layers": c.n_layers, "max_abs_logit": float(dec32.abs().amax()),
            "bf16_prefill_vs_decode": err(pre, dec),
            "bf16_prefill_vs_f32": err(pre, pre32),
            "bf16_decode_vs_f32": err(dec, dec32),
            "f32_prefill_vs_decode": err(pre32, dec32),
            "full_reductions_prefill_vs_decode": err(pre_f, dec_f),
            "full_reductions_prefill_vs_f32": err(pre_f, pre32),
            "full_reductions_decode_vs_f32": err(dec_f, dec32)})
        rows[-1]["faults"] = fault_readings(c, model, model32, p, p32, toks,
                                            dec, pre32, dec32)
        print(f"  {cfg.name} {json.dumps(rows[-1])}", flush=True)
        del model, model32, p32
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["mamba2_780m"])
    ap.add_argument("--depths", default="1,8,24,48")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import gc
    import shutil
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("prefill_probe: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    print(cs.nvidia_smi_line(), flush=True)
    depths = [int(d) for d in args.depths.split(",")]
    out = {}
    shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)
    try:
        for arch in args.arch:
            with cs.phase(f"probe:{arch}"):
                tr, _, _ = cs.train_family_part(
                    arch, dict(cs.TRAIN_FAMILIES)[arch])
                n = tr.model.cfg.n_layers
                out[arch] = readings(tr, [d for d in depths if d <= n])
                del tr
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

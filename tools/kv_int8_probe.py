#!/usr/bin/env python3
"""Time variants of the int8 instance of ``csrc/kv_visit.cu`` side by side.

    python3 tools/kv_int8_probe.py [--root DIR] [--label NAME]
        [--variants as_is,copy,...] [--bps N,...] [--rounds N] [--sass]
        [--out FILE.json]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout; the
parent commit unpacked with ``git archive`` under ``build/`` for a before /
after reading) and ``chip_smoke`` from this tool's checkout. For each
variant it copies that checkout's ``kv_visit.cu`` (and ``common.cuh``) under
``build/kv_probe/``, applies the variant's text patch, and builds it with
that checkout's nvcc flags (one ``nvcc`` per variant, all in parallel). The
variants:

- ``as_is``: the source unchanged;
- ``copy``: the bf16 int8 instance's dequantization reduced to a copy of
  the code bytes (wrong numbers, the time without the conversion): in a
  source that stages a bf16 tile (``store_deq16``), the tile is written
  from the raw bytes; in one that dequantizes in registers
  (``deq_pair``), the operand is the raw word;
- ``magic``: (register source only) each code's float32 made by a byte
  permute into 2^23's bits (its sign bit flipped) minus 2^23 + 128, the
  pair's bf16 from the floats' high halves, then the same bf16x2 multiply;
- ``cvt``: (register source only) the float32 codes times the float32
  scales by one FFMA each (exact), the pair rounded by
  ``cvt.rn.bf16x2.f32``;
- ``nocompute``: the ring fills and drains, no warp computes (the
  memory pipeline alone);
- ``noscales``: the scales are not staged (the codes alone);
- ``nomemory``: every copy of the ring zero-fills instead of reading
  the cache (the warps' work alone, on zeros);
- ``a+b``: the patches of ``a`` and of ``b``.

Each variant's library is installed in place of the built one
(``_build._LIBS``) and ``kv_visit_attention[int8]`` runs at
deepseek-moe-16b's long-context shape (B = 4, KV = 16, G = 1, hd = 128,
16 of 64 blocks of 512 at 32,768 slots) and at the server shape (4 of 32
blocks of 32 at 1,024 slots, positions 77, 127, 80, 97), both made by
``chip_smoke.decode_kv_int8_case`` (seed 1), at the split plan of that
checkout's ``kv_visit.split_plan`` with the SM count times each of
``--bps`` (blocks per SM; default: the checkout's ``blocks_per_sm``). Per
variant, blocks per SM and shape: the device ms per call
(``chip_smoke.device_kernels``), the eager CUDA-event ms
(``chip_smoke.time_ms``) and max |kernel - plain| (``as_is`` must be
within ``chip_smoke.KV_RTOL``; the others are timed only). The bf16
instance on the dequantized cache is timed beside them (its own library,
unpatched). With ``--sass`` each variant's static SASS of the bf16 int8
instance at hd = 128 is kept beside its build (``cuobjdump -sass``) and
its opcode counts printed. The variants run in ``--rounds`` rounds, in
the order given and then reversed (A B B A ...). Prints the card's name
and power limit
first; exits non-zero without a CUDA device or when ``as_is`` is off.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SASS = False   # --sass
SHAPES = {"long": ([32766 - 64 * b for b in range(4)], 32768, 512, 16),
          "server": ([77, 127, 80, 97], 1024, 32, 4)}

# variant -> [(old, new)]: each variant needs at least one of its patches
# to apply; a patch whose old text is absent is skipped
PATCHES = {
    "as_is": [],
    "copy": [
        # a staged bf16 tile: the 16 codes' bytes written as the tile's 32
        ("    w[2 * i] = pack_bf16(static_cast<float>(c[i].x) * s, "
         "static_cast<float>(c[i].y) * s);\n"
         "    w[2 * i + 1] = pack_bf16(static_cast<float>(c[i].z) * s, "
         "static_cast<float>(c[i].w) * s);\n",
         "    w[2 * i] = (&raw.x)[i];\n    w[2 * i + 1] = (&raw.x)[i];\n"),
        # in registers: the operand is the staged word itself
        ("  // deq_pair body (tools/kv_int8_probe.py patches its variants in here)\n", "  return w0;\n"),
    ],
    "magic": [
        ("  // deq_pair body (tools/kv_int8_probe.py patches its variants in here)\n",
         "  const float c0 = __uint_as_float(__byte_perm(w0 ^ 0x80808080u, "
         "0x4B000000u, 0x7650u | e0)) - 8388736.f;\n"
         "  const float c1 = __uint_as_float(__byte_perm(w1 ^ 0x80808080u, "
         "0x4B000000u, 0x7650u | e1)) - 8388736.f;\n"
         "  return bf16x2_mul(__byte_perm(__float_as_uint(c0), "
         "__float_as_uint(c1), 0x7632u), s2);\n"),
    ],
    "cvt": [
        ("  // deq_pair body (tools/kv_int8_probe.py patches its variants in here)\n",
         "  const float2 s = __bfloat1622float2("
         "*reinterpret_cast<const __nv_bfloat162*>(&s2));\n"
         "  const float m0 = __uint_as_float(__byte_perm(w0 ^ 0x80808080u, "
         "0x4B000000u, 0x7650u | e0));\n"
         "  const float m1 = __uint_as_float(__byte_perm(w1 ^ 0x80808080u, "
         "0x4B000000u, 0x7650u | e1));\n"
         "  return pack_bf16(fmaf(m0, s.x, -8388736.f * s.x), "
         "fmaf(m1, s.y, -8388736.f * s.y));\n"),
    ],
    "nocompute": [
        ("w.run(tile, live0, uniform, a.scale, a.neg);",
         "if (live0 > S::TK) w.run(tile, live0, uniform, a.scale, a.neg);"),
        ("    w.run(tile, live, uniform, a.scale, a.neg);\n",
         "    if (live > S::TK) w.run(tile, live, uniform, a.scale, a.neg);\n"),
    ],
    "noscales": [
        ("      cp_async4(sc + r, t.ks + r * a.kss.t, bytes);\n"
         "      cp_async4(sc + S::TK + r, t.vs + r * a.vss.t, bytes);\n",
         "      (void)sc;\n"),
    ],
    "nomemory": [
        ("r < t.live ? 16 : 0", "0"),
        ("r < t.live ? 4 : 0", "0"),
    ],
}


def patched(src: str, variant: str) -> str:
    """``src`` with the patches of ``variant`` ('+'-joined variants apply
    each one's)."""
    if "+" in variant:
        for v in variant.split("+"):
            src = patched(src, v)
        return src
    out, applied = src, 0
    for old, new in PATCHES[variant]:
        if old in out:
            out = out.replace(old, new)
            applied += 1
    if PATCHES[variant] and not applied:
        raise SystemExit(f"kv_int8_probe: no patch of {variant!r} applies")
    return out


def registers(log: str) -> dict:
    """{kernel entry: 'N registers, M bytes spill stores'} from ptxas -v."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and entry:
            out[entry] = f"spills {m.group(1)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry] = f"{m.group(1)} registers, {out.get(entry, '')}"
    return out


def sass_histogram(lib: Path, out: Path) -> dict:
    """The static SASS of the bf16 int8 instance at hd = 128 (``cuobjdump
    -sass``, written to ``out``) -> {opcode: count}, largest first."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if f.startswith("_Z") and
                 "kv_visit_kernelI13__nv_bfloat16Li128ELb1E" in f.split()[0]),
                "")
    out.write_text(body)
    counts: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         body):
        op = m.group(1)
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def build(root: Path, label: str, variants: list) -> dict:
    """One library per variant, built in parallel -> {variant: ctypes lib}."""
    from repro_torch.kernels import _build
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "kv_visit.cu").read_text()
    procs = {}
    for v in variants:
        d = HERE / "build" / "kv_probe" / f"{label}-{v}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "common.cuh", d / "common.cuh")
        (d / "kv_visit.cu").write_text(patched(src, v))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "kv_visit.so"), str(d / "kv_visit.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for v, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kv_int8_probe: nvcc failed on {v}:\n{log}")
        print(f"[{label}] {v}: built; hd 128 instances (ptxas -v): "
              + ", ".join(f"{k}: {r}" for k, r in registers(log).items()
                          if "Li128E" in k), flush=True)
        if SASS:
            hist = sass_histogram(d / "kv_visit.so", d / "sass.txt")
            print(f"[{label}] {v}: SASS of the bf16 int8 hd 128 instance, "
                  f"{sum(hist.values())} instructions: "
                  + ", ".join(f"{k} {n}" for k, n in hist.items()),
                  flush=True)
        lib = ctypes.CDLL(str(d / "kv_visit.so"))
        lib.mdrq_error_string.argtypes = (ctypes.c_int,)
        lib.mdrq_error_string.restype = ctypes.c_char_p
        for sym in ("mdrq_kv_visit_attention", "mdrq_kv_visit_shape"):
            getattr(lib, sym).argtypes = _build._SIGNATURES[sym]
            getattr(lib, sym).restype = ctypes.c_int
        libs[v] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", default="as_is,copy")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS opcode counts")
    ap.add_argument("--bps", default="",
                    help="blocks per SM to plan with, comma-separated")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    root = args.root.resolve()
    global SASS
    SASS = args.sass
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import torch
    if Path(repro_torch.__file__).resolve().parent != \
            (root / "src" / "repro_torch").resolve():
        raise SystemExit("kv_int8_probe: repro_torch not imported from --root")
    if not torch.cuda.is_available():
        print("kv_int8_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, kv_visit, ref
    variants = args.variants.split(",")
    smi = cs.nvidia_smi_line()
    print(f"[{args.label}] {smi}; root {root}", flush=True)
    _build.library("mdrq_kv_visit_attention")   # the checkout's own build
    libs = build(root, args.label, variants)
    own = dict(_build._LIBS)
    own_bps = kv_visit.blocks_per_sm
    bps_list = [int(n) for n in args.bps.split(",")] if args.bps else [None]
    rows, ok = [], True
    for shape, case in SHAPES.items():
        q, kq, vq, ids, pos, ks, vs = cs.decode_kv_int8_case(*case)
        want = ref.kv_visit_attention_ref(q, kq, vq, ids, pos, ks, vs)
        b_ms = cs.kv_int8_bound(q, ids, pos, kq.shape[3])[0]
        kd = (kq.to(q.dtype) * ks.to(q.dtype))
        vd = (vq.to(q.dtype) * vs.to(q.dtype))
        t16 = cs.device_kernels(
            lambda: kv_visit.kv_visit_attention(q, kd, vd, ids, pos))[0]
        print(f"[{args.label}] {shape}: bound {b_ms:.5f} ms; bf16 instance "
              f"on the dequantized cache {t16:.5f} device ms", flush=True)
        runs = [(v, n) for v in variants for n in bps_list]
        order = []
        for r in range(args.rounds):
            order += runs if r % 2 == 0 else runs[::-1]
        for v, n in order:
            for sym in ("mdrq_kv_visit_attention", "mdrq_kv_visit_shape"):
                _build._LIBS[sym] = libs[v]
            own_bps.cache_clear()
            kv_visit.blocks_per_sm = own_bps if n is None else \
                (lambda hd, dtype, int8, n=n: n)

            def call():
                return kv_visit.kv_visit_attention(q, kq, vq, ids, pos, ks,
                                                   vs)
            err, scale = cs.kv_err(call(), want)
            dev_ms, per_call, _ = cs.device_kernels(call)
            ms = cs.time_ms(call)
            good = v != "as_is" or (err <= cs.KV_RTOL * scale
                                    and per_call == 1)
            ok &= good
            smem = kv_visit.instance_shape(q.shape[-1], q.dtype, True)[1]
            rows.append({"shape": shape, "variant": v, "bps_forced": n,
                         "device_ms": dev_ms,
                         "ms": ms, "err": err, "bound_ms": b_ms,
                         "bf16_device_ms": t16, "smem": smem,
                         "blocks_per_sm": kv_visit.blocks_per_sm(
                             q.shape[-1], q.dtype, True)})
            print(f"[{args.label}] {shape:<6} {v:<6} device_ms {dev_ms:.5f} "
                  f"ms {ms:.5f} err {err:.4g} (scale {scale:.4g}) smem "
                  f"{smem} blocks/SM {rows[-1]['blocks_per_sm']}"
                  f"{'' if good else '  FAILED'}", flush=True)
        _build._LIBS.update(own)
        kv_visit.blocks_per_sm = own_bps
        own_bps.cache_clear()
        del q, kq, vq, ks, vs, kd, vd
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"smi": smi, "label": args.label,
                                        "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())

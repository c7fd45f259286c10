"""Build the CUDA kernels at first use and bind them with ctypes.

Each source in ``csrc/`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). All
sources compile in parallel, one ``nvcc`` process each. Libraries land in
``build/torch_ext/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of their sources and flags, so an edited source rebuilds and
an unchanged one is reused. nvcc's output (``ptxas -v``: registers, spills)
is kept beside each library and read into ``BUILD_LOG`` when it is reused.

Nothing here runs at import time: the first launch on a CUDA tensor calls
``library()``. A missing compiler or a failed build raises.

Launch accounting: ``launch(name, ...)`` is the one place a kernel launch is
issued, and it adds one to ``LAUNCHES[name]`` only after the launch was
accepted — each wrapper passes its own name, so the count belongs to the
wrapper that launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("scan.cu", "reducers.cu", "visit.cu", "va_filter.cu", "rows.cu",
           "kv_visit.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
# C signature of every exported launcher (all return a cudaError_t as int).
_SIGNATURES = {
    "mdrq_scan": (_P, _LL, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P),
    "mdrq_masked_fill": (_P, _P, _F, _LL, _I, _P, _I, _I, _P),
    "mdrq_masked_agg": (_P, _P, _I, _F, _LL, _I, _P, _I, _I, _P),
    "mdrq_multi_scan_visit": (_P, _LL, _I, _P, _LL, _P, _P, _I, _I, _P, _I,
                              _P),
    "mdrq_multi_scan_visit_sorted": (_P, _LL, _I, _P, _P, _LL, _P, _P, _I, _I,
                                     _P, _I, _P),
    "mdrq_multi_va_filter": (_P, _LL, _I, _I, _P, _P, _I, _P, _I, _I, _P),
    "mdrq_range_scan_rows": (_P, _LL, _I, _P, _P, _P, _I, _P),
    "mdrq_kv_visit_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL,
                                _LL, _LL, _LL, _LL, _LL, _LL, _LL, _F, _F, _I,
                                _P),
    "mdrq_kv_visit_shape": (_I, _I, _PI, _PI),
}

# Kernel launches per wrapper name since the last ``reset_launches``.
LAUNCHES: dict[str, int] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}   # exported symbol -> its library
BUILD_LOG: dict[str, str] = {}       # source -> nvcc's output (ptxas -v)
BUILD_SECONDS: float = 0.0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from kernels/csrc at first use")
    return nvcc


def _digest(src: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # sources and shared headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(src.encode())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source that has no up-to-date library; returns source
    -> library path. Sources compile in parallel; any failure raises with
    nvcc's output."""
    global BUILD_SECONDS
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src: BUILD_DIR / f"{Path(src).stem}-{_digest(src)}.so"
            for src in SOURCES}
    procs = {}
    for src, lib in libs.items():
        if lib.exists():
            log = lib.with_suffix(".log")
            if log.exists():
                BUILD_LOG.setdefault(src, log.read_text())
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    BUILD_SECONDS = time.perf_counter() - t0
    return libs


def _load() -> None:
    for lib_path in build().values():
        lib = ctypes.CDLL(str(lib_path))
        lib.mdrq_error_string.argtypes = (ctypes.c_int,)
        lib.mdrq_error_string.restype = ctypes.c_char_p
        for sym, argtypes in _SIGNATURES.items():
            fn = getattr(lib, sym, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _LIBS[sym] = lib


def library(sym: str) -> ctypes.CDLL:
    """The loaded library exporting ``sym`` (builds everything on first use)."""
    with _LOCK:
        if not _LIBS:
            _load()
    return _LIBS[sym]


def launch(name: str, sym: str, device: torch.device, *args) -> None:
    """Launch C entry point ``sym`` on ``device``'s current stream; raise on
    a refused launch, else count one launch for wrapper ``name``.

    ``args`` are the launcher's arguments before (device, stream); tensors
    pass as their data pointers and must outlive the call — the wrapper
    holds them.
    """
    lib = library(sym)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, sym)(*c_args, index, stream)
    if err != 0:
        msg = lib.mdrq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}): {msg}")
    with _LOCK:   # exact when two threads launch
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    with _LOCK:
        LAUNCHES.clear()

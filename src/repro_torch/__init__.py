"""repro_torch — the MDRQ engine in PyTorch, with its kernels in CUDA for Hopper.

A port of the JAX package ``repro`` that mirrors its layout (``core/``,
``kernels/``, ``obs/``, ``serve/``, ``data/``, ``configs/``, ``models/``,
``launch/``) and module names. It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``. Besides the MDRQ engine it runs the LM
decode-serving path (dense models, zone-map KV block prune) behind
``serve.BatchServer``, whose admission filter is an MDRQ.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. On a CUDA tensor the kernel wrappers launch the hand-written
CUDA kernels (built from ``kernels/csrc`` at first use); on a CPU tensor they
run the plain PyTorch versions in ``kernels/ref.py``. The plain versions run on
CUDA only when asked for with ``backend="torch"``.
"""
from repro_torch.core import (Compactor, DeltaHostCtx, DeltaView, MDRQEngine,
                              MutableDelta, RowScan, build_row_scan)

__all__ = ["MDRQEngine", "RowScan", "build_row_scan", "MutableDelta",
           "DeltaView", "Compactor", "DeltaHostCtx"]

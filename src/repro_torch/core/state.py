"""Carry an engine's state across from the host arrays it was built from.

The system has no weights: what a reference engine holds is the dataset it
was built from — ``Dataset.cols``, an (m, n) float32 array — plus what it
derives from it (the padded columnar array on the device and the planner's
histograms). ``engine_from_arrays`` rebuilds the port's engine from that same
array, so the two engines hold the same padded data bit for bit and the same
histograms.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types as T
from repro_torch.core.engine import STRUCTURES, MDRQEngine


def engine_from_arrays(cols: np.ndarray, *, tile_n: int = 1024,
                       structures: tuple[str, ...] = STRUCTURES,
                       device=None, mesh=None) -> MDRQEngine:
    """The port's engine over ``cols`` ((m, n) float32, the reference's
    ``Dataset.cols``), on ``device`` (``None`` = cuda, or the first device
    of ``mesh``, a ``core.distributed.DataMesh`` the scan shards over)."""
    return MDRQEngine(T.Dataset(cols), structures=structures, tile_n=tile_n,
                      device=device, mesh=mesh)

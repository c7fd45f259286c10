"""VA-file approximation filter on packed 2-bit cell codes.

Ports ``repro/kernels/va_filter.py`` (``va_filter_packed``,
``multi_va_filter_packed``). The paper's VA-file (§2.2.3, §5.3) quantizes
every dimension to 2 bits and scans the *approximations* first; only blocks
whose approximation intersects the approximated query are refined against
the exact data.

Packing: word ``w`` of object ``i`` holds dims ``[16w, 16w+16)`` — dim
``16w + k`` occupies bits ``[2k, 2k+2)``. On a CUDA tensor each wrapper
launches ``multi_va_filter_kernel`` in ``csrc/va_filter.cu`` (the single-query
form is its Q=1 launch), which tests the 16 fields of a word at once against
four per-(query, word) cell masks that it builds in its prologue, so a launch
needs no other device work; on a CPU tensor it runs the plain version in
``ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.range_scan import LANES, block_threads, cuda_input

# The paper's static cell resolution (b_j = 2, §2.2.3). Word packing density,
# the planner's candidate-fraction slack and approximation byte count, and
# ``core.vafile.CELLS`` all derive from this one constant.
BITS_PER_DIM = 2
CODE_MASK = (1 << BITS_PER_DIM) - 1
DIMS_PER_WORD = 32 // BITS_PER_DIM


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack (m, n) uint8 cell codes into (ceil(m/DIMS_PER_WORD), n) int32."""
    m, n = codes.shape
    w = -(-m // DIMS_PER_WORD)
    out = np.zeros((w, n), dtype=np.int32)
    for d in range(m):
        wi, k = divmod(d, DIMS_PER_WORD)
        out[wi] |= codes[d].astype(np.int32) << (BITS_PER_DIM * k)
    return out


def _check(packed: torch.Tensor, cell_lo: torch.Tensor, cell_hi: torch.Tensor,
           m: int) -> None:
    w, n_pad = packed.shape
    if n_pad % LANES:
        raise ValueError(f"n_pad={n_pad} is not a multiple of {LANES}")
    if not 1 <= m <= w * DIMS_PER_WORD:
        raise ValueError(f"m={m} does not fit {w} packed words")
    if cell_lo.ndim != 2 or cell_lo.shape[0] < m or cell_lo.shape[1] < 1 \
            or cell_hi.shape != cell_lo.shape:
        raise ValueError(f"cell bounds {tuple(cell_lo.shape)}, "
                         f"{tuple(cell_hi.shape)} are not (m_s >= {m}, Q >= 1)")


def _filter_cuda(name: str, packed: torch.Tensor, cell_lo: torch.Tensor,
                 cell_hi: torch.Tensor, m: int) -> torch.Tensor:
    """Launch ``multi_va_filter_kernel`` -> (Q, n_pad) int8; counted as
    ``name``."""
    dev = packed.device
    words = cuda_input(packed, torch.int32, "packed", dev)
    w, n_pad = words.shape
    for b, label in ((cell_lo, "cell_lo"), (cell_hi, "cell_hi")):
        if b.device != dev:
            raise ValueError(f"{label} is on {b.device}, packed on {dev}")
    lo = cell_lo.to(torch.int32).contiguous()
    hi = cell_hi.to(torch.int32).contiguous()
    q_n = lo.shape[1]
    out = torch.empty((q_n, n_pad), dtype=torch.int8, device=dev)
    _build.launch(name, "mdrq_multi_va_filter", dev, words, n_pad, w, m, lo,
                  hi, q_n, out, block_threads(n_pad))
    return out


def va_filter_packed(
    packed: torch.Tensor,
    cell_lo: torch.Tensor,
    cell_hi: torch.Tensor,
    m: int,
) -> torch.Tensor:
    """Candidate mask of one query from packed approximations.

    Args:
      packed: (w, n_pad) int32 packed codes, n_pad % LANES == 0.
      cell_lo, cell_hi: (m_s, 1) int32 query cell bounds, m_s >= m (rows from
        m on are never read).
      m: true dimensionality.

    Returns:
      (n_pad,) int8 candidate mask.
    """
    _check(packed, cell_lo, cell_hi, m)
    if cell_lo.shape[1] != 1:
        raise ValueError(f"cell bounds {tuple(cell_lo.shape)} are not (m_s, 1)")
    if not packed.is_cuda:
        return _ref.va_filter_packed_ref(packed, cell_lo[:, 0], cell_hi[:, 0], m)
    return _filter_cuda("va_filter_packed", packed, cell_lo, cell_hi, m)[0]


def multi_va_filter_packed(
    packed: torch.Tensor,
    cell_lo: torch.Tensor,
    cell_hi: torch.Tensor,
    m: int,
) -> torch.Tensor:
    """Candidate masks for a whole query batch from one launch.

    Args:
      packed: (w, n_pad) int32 packed codes, n_pad % LANES == 0.
      cell_lo, cell_hi: (m_s, Q) int32 per-query cell bounds, query-minor
        (one column per query, like the ``multi_scan`` bounds layout).
      m: true dimensionality.

    Returns:
      (Q, n_pad) int8 candidate masks, row q = query q.
    """
    _check(packed, cell_lo, cell_hi, m)
    if not packed.is_cuda:
        return _ref.multi_va_filter_packed_ref(packed, cell_lo, cell_hi, m)
    return _filter_cuda("multi_va_filter_packed", packed, cell_lo, cell_hi, m)

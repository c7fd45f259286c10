"""Block-visit decode attention (zone-map-pruned KV cache).

Ports ``repro/kernels/kv_visit.py``: one decode token's grouped query rows
attend over only the key blocks a per-(batch, kv-head) visit list names —
the paper's two-phase refine (prune by bounding box, then visit) applied to
attention. On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/kv_visit.cu``; on a CPU tensor it runs the plain version
(``ref.kv_visit_attention_ref``).

The kernel reads K and V in place through strides: the model passes the
block-major *view* ``cache.view(B, nb, bs, KV, hd).permute(0, 3, 1, 2, 4)``
of its token-major ``(B, S, KV, hd)`` cache, never a copy; any view whose
last axis is contiguous and whose rows start 16-byte aligned is taken. The
visit list's ids arrive as int64 from the top-k selection and are cast to
int32 once, here.
"""
from __future__ import annotations

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

KV_TILE = 128                      # keys per thread block, at most
TILE_BYTES = 32 * 1024             # K rows per thread block (csrc/kv_visit.cu)
MAX_GROUP = 8                      # query rows per kv head the kernel takes
HEAD_DIMS = (32, 64, 128, 256)     # head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, k_blocks, v_blocks, block_ids, pos) -> None:
    """Raise unless the five inputs have the shapes the op takes."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, hd), got {tuple(q.shape)}")
    b, kv, g, hd = q.shape
    for name, x in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        if x.dim() != 5 or x.shape[:2] != (b, kv) or x.shape[4] != hd:
            raise ValueError(f"{name} must be (B, KV, nb, bs, hd) = ({b}, {kv}, "
                             f"nb, bs, {hd}), got {tuple(x.shape)}")
    if k_blocks.shape != v_blocks.shape:
        raise ValueError(f"k_blocks {tuple(k_blocks.shape)} != v_blocks "
                         f"{tuple(v_blocks.shape)}")
    if block_ids.dim() != 3 or block_ids.shape[:2] != (b, kv) \
            or block_ids.shape[2] < 1:
        raise ValueError(f"block_ids must be (B, KV, n_visit >= 1), got "
                         f"{tuple(block_ids.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    devs = {t.device for t in (q, k_blocks, v_blocks, block_ids, pos)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def kv_visit_attention(q: torch.Tensor, k_blocks: torch.Tensor,
                       v_blocks: torch.Tensor, block_ids: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Decode attention over only the listed key blocks -> (B, KV, G, hd).

    q: (B, KV, G, hd); k/v_blocks: (B, KV, nb, bs, hd) (strided views
    welcome); block_ids: (B, KV, n_visit), -1 = padding, else in [0, nb);
    pos: (B,) decode positions.
    """
    check_inputs(q, k_blocks, v_blocks, block_ids, pos)
    if not q.is_cuda:
        return _ref.kv_visit_attention_ref(q, k_blocks, v_blocks, block_ids, pos)
    return _launch(q, k_blocks, v_blocks, block_ids, pos)


def _launch(q, k_blocks, v_blocks, block_ids, pos) -> torch.Tensor:
    b, kv, g, hd = q.shape
    nb, bs = k_blocks.shape[2], k_blocks.shape[3]
    n_visit = block_ids.shape[2]
    if q.dtype not in DTYPES or k_blocks.dtype != q.dtype \
            or v_blocks.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}, {k_blocks.dtype}, "
                        f"{v_blocks.dtype}: the kernel takes one of {DTYPES} "
                        f"for all three")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"{g} query rows per kv head; the kernel takes "
                         f"<= {MAX_GROUP}")
    # Rows are copied in 16-byte pieces: each must start 16-byte aligned.
    for name, x in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        if x.stride(4) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")
        if any(s * x.element_size() % 16 for s in x.stride()[:4]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: strides and start must be multiples of "
                             f"16 bytes")
    qc = q.contiguous()
    ids = block_ids.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    tile = min(KV_TILE, TILE_BYTES // (hd * q.element_size()))
    n_split = n_visit * -(-bs // tile)
    part = torch.empty((n_split, b * kv, g, hd + 2), dtype=torch.float32,
                       device=q.device)
    ks, vs = k_blocks.stride(), v_blocks.stride()
    _build.launch("kv_visit_attention", "mdrq_kv_visit_attention", q.device,
                  qc, k_blocks, v_blocks, ids, pos32, out, part,
                  int(q.dtype == torch.bfloat16), b, kv, g, hd, nb, bs, n_visit,
                  tile, *ks[:4], *vs[:4], hd ** -0.5,
                  numerics.mask_fill(torch.bfloat16))
    return out

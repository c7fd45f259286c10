"""Block-visit decode attention (zone-map-pruned KV cache).

Ports ``repro/kernels/kv_visit.py``: one decode token's grouped query rows
attend over only the key blocks a per-(batch, kv-head) visit list names —
the paper's two-phase refine (prune by bounding box, then visit) applied to
attention. On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/kv_visit.cu`` (one kernel per call); on a CPU tensor it runs the
plain version (``ref.kv_visit_attention_ref``).

The kernel reads K and V in place through strides: the model passes the
block-major *view* ``cache.view(B, nb, bs, KV, hd).permute(0, 3, 1, 2, 4)``
of its token-major ``(B, S, KV, hd)`` cache, never a copy; any view whose
last axis is contiguous and whose rows start 16-byte aligned is taken. The
visit list's ids (int64 from the top-k selection, or int32) and the
positions (int64 or int32) are read as they come: no cast is launched.

Work split (``split_plan``, a function of the shapes alone): each listed
block is cut into tiles of ``tile_keys`` keys, the list's tiles into
``n_split`` contiguous runs of ``tps`` tiles, one thread block per run and
(b, kv head). Each block leaves a softmax partial in a scratch buffer; the
last of a (b, kv head)'s blocks to finish, told by an integer ticket that it
resets (one set of tickets per device and stream), merges them in split
order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

MAX_GROUP = 8                      # query rows per kv head the kernel takes
HEAD_DIMS = (32, 64, 128, 256)     # head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int64, torch.int32)
MAX_SPLIT = 32                     # blocks per (b, kv head)
# A list of at most this many tiles runs as one block: on an H100, splitting
# it gains nothing and adds the merge (tools/kv_split_sweep.py, PERF.md).
UNSPLIT_TILES = 4


def tile_keys(hd: int, dtype: torch.dtype) -> int:
    """Keys per tile of the kernel's instance (``Shape::TK`` in the
    source, which refuses a launch planned with another): 64 in bf16 (four
    warps of 16 keys), 16 KB of K rows in float32, at most 64."""
    return 64 if dtype == torch.bfloat16 else min(64, 16384 // (hd * 4))


def instance_shape(hd: int, dtype: torch.dtype) -> tuple[int, int]:
    """(keys per tile, dynamic shared memory bytes per thread block) of the
    kernel's instance as the built library reports them (``Shape::TK``,
    ``Shape::SMEM``); builds the kernels on first use."""
    tile, smem = ctypes.c_int(), ctypes.c_int()
    err = _build.library("mdrq_kv_visit_shape").mdrq_kv_visit_shape(
        int(dtype == torch.bfloat16), hd, ctypes.byref(tile),
        ctypes.byref(smem))
    if err:
        raise ValueError(f"kv_visit.cu has no instance for {dtype}, hd {hd}")
    return tile.value, smem.value


def split_plan(bkv: int, n_visit: int, bs: int, tile: int,
               sms: int) -> tuple[int, int]:
    """(n_split, tiles per split) for ``bkv`` = B * KV lists of ``n_visit``
    blocks of ``bs`` keys on a card of ``sms`` SMs. Split s takes tiles
    [s * tps, (s + 1) * tps) of the list's n_visit * ceil(bs / tile) tiles
    (tile i: block i // ceil(bs / tile), keys from (i % ceil(bs / tile)) *
    tile); every split has at least one tile. The grid fills one wave of one
    block per SM (on an H100 a block streams faster alone on its SM than
    beside a second one, though two fit), unless B * KV alone exceeds it; a
    list of at most UNSPLIT_TILES tiles is not split."""
    n_tiles = n_visit * -(-bs // tile)
    if n_tiles <= UNSPLIT_TILES:
        return 1, n_tiles
    n_split = min(MAX_SPLIT, n_tiles, max(1, sms // bkv))
    tps = -(-n_tiles // n_split)
    return -(-n_tiles // tps), tps


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The ticket counters of launches on ``stream``, one per (b, kv head):
    zeros, and left zero by every launch (allocated once per device and
    stream, on that stream, and grown when B * KV grows). Launches on one
    stream run one after another; two streams never share counters."""
    key = (stream.device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=stream.device)
    return t


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
    pos: (B,) decode positions. Ids and positions int64 or int32.
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
    if block_ids.dtype not in INDEX_DTYPES or pos.dtype not in INDEX_DTYPES:
        raise TypeError(f"block_ids {block_ids.dtype}, pos {pos.dtype}: the "
                        f"kernel reads {INDEX_DTYPES}")
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
    # (no-ops for the model's inputs: q, the ids and pos arrive contiguous)
    qc, ids, pos = q.contiguous(), block_ids.contiguous(), pos.contiguous()
    out = torch.empty_like(qc)
    tile = tile_keys(hd, q.dtype)
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    n_split, tps = split_plan(b * kv, n_visit, bs, tile, _sm_count(index))
    part = tickets = None
    if n_split > 1:
        part = torch.empty((n_split, b * kv, g, hd + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(torch.cuda.current_stream(q.device), b * kv)
    _build.launch("kv_visit_attention", "mdrq_kv_visit_attention", q.device,
                  qc, k_blocks, v_blocks, ids, pos, out, part, tickets,
                  int(ids.dtype == torch.int64), int(pos.dtype == torch.int64),
                  int(q.dtype == torch.bfloat16), b, kv, g, hd, nb, bs, n_visit,
                  tile, n_split, tps, *k_blocks.stride()[:4],
                  *v_blocks.stride()[:4], hd ** -0.5,
                  numerics.mask_fill(torch.bfloat16))
    return out

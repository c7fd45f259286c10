"""The block-visit attention kernel's split plan and merge, on the CPU.

``csrc/kv_visit.cu`` runs only on the card (``tests/test_torch_cuda.py``
holds it against its plain version there). How it divides the work and how
it merges the pieces are modelled here:

- ``kv_visit.split_plan`` (what the wrapper launches): every (visit, key)
  position of a list lies in exactly one tile of exactly one split, no
  split is empty and none reaches past the list, at one visit, blocks of 33
  and 200 keys (not multiples of the tile), more splits than visits, split
  boundaries inside a block, B * KV at and above the SM count, the
  long-context decode shape (4 splits of 32 tiles: 128 blocks, one wave of
  one per SM) and the server's (4 tiles: one split);
- a PyTorch model of the kernel's arithmetic at that plan: per tile only
  the valid prefix (or every key, when no key of the list is valid), per
  warp a softmax partial (m, l, acc) over the keys it takes (bf16
  instance: 16-key groups round robin over 4 warps; float32: every 4th
  key), the warps merged in warp order, then the splits in split order (by
  the last block of the (b, kv head) to finish) —
  held against the reference's Pallas ``kv_visit_attention`` in interpret
  mode, its jnp oracle and ``ref.kv_visit_attention_ref``, in float32 at
  rtol = atol = 1e-5 (sums in another order), with padding ids spread over
  the splits, repeated ids, a position inside a tile, and a list with no
  valid key.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_visit import kv_visit_attention as jax_kv_visit
from repro.kernels.ref import kv_visit_attention_ref as jax_kv_visit_ref
from repro_torch import numerics
from repro_torch.kernels import kv_visit, ref

H100_SMS = 132
WARPS = 4
TOL = 1e-5


def expand(n_split, tps, n_visit, bs, tile):
    """The (visit, key) positions of each split, as the kernel's tile_of
    walks them."""
    per_visit = -(-bs // tile)
    n_tiles = n_visit * per_visit
    out = []
    for s in range(n_split):
        keys = []
        for ti in range(s * tps, min((s + 1) * tps, n_tiles)):
            j, t0 = ti // per_visit, (ti % per_visit) * tile
            keys += [(j, t0 + r) for r in range(min(tile, bs - t0))]
        out.append(keys)
    return out


# (B * KV, n_visit, bs, tile, sms)
PLAN_CASES = {
    "one_visit": (32, 1, 512, 64, H100_SMS),
    "bs33": (8, 4, 33, 64, H100_SMS),
    "bs200": (8, 3, 200, 64, H100_SMS),
    "bs200_f32_tile16": (2, 5, 200, 16, H100_SMS),
    "more_splits_than_visits": (4, 2, 512, 32, H100_SMS),
    "bkv_at_sms": (H100_SMS, 16, 512, 64, H100_SMS),
    "bkv_above_sms": (4 * 40, 4, 32, 64, H100_SMS),
    "bkv_far_above_sms": (1024, 64, 32, 64, H100_SMS),
    "long_context": (32, 16, 512, 64, H100_SMS),
    "server": (32, 4, 32, 64, H100_SMS),
    "many_visits": (2, 64, 16, 64, H100_SMS),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_plan_covers_every_key_once(case):
    bkv, n_visit, bs, tile, sms = PLAN_CASES[case]
    n_split, tps = kv_visit.split_plan(bkv, n_visit, bs, tile, sms)
    assert 1 <= n_split <= kv_visit.MAX_SPLIT
    splits = expand(n_split, tps, n_visit, bs, tile)
    assert all(splits), "an empty split"
    flat = [k for keys in splits for k in keys]
    assert sorted(flat) == [(j, t) for j in range(n_visit) for t in range(bs)]
    assert len(set(flat)) == len(flat)
    # one wave: no more blocks than SMs, unless the lists alone ask for more
    assert bkv * n_split <= max(bkv, sms)
    # a short list is one split
    assert n_split == 1 or n_visit * -(-bs // tile) > kv_visit.UNSPLIT_TILES


def test_split_plan_shapes():
    # the long-context decode: 4 splits of 32 tiles of 64 keys
    assert kv_visit.split_plan(32, 16, 512, 64, H100_SMS) == (4, 32)
    # the server: 4 blocks of 32 keys, one tile each, in one split
    assert kv_visit.split_plan(32, 4, 32, 64, H100_SMS) == (1, 4)
    assert kv_visit.split_plan(32, 5, 32, 64, H100_SMS) == (3, 2)
    # more splits than visits: 2 visits of 16 tiles in 32 splits of 1
    assert kv_visit.split_plan(4, 2, 512, 32, H100_SMS) == (32, 1)
    assert kv_visit.split_plan(32, 1, 512, 64, H100_SMS) == (4, 2)
    # B * KV at and above the SM count: 1 split
    assert kv_visit.split_plan(H100_SMS, 16, 512, 64, H100_SMS) == (1, 128)
    assert kv_visit.split_plan(66, 16, 512, 64, H100_SMS) == (2, 64)
    assert kv_visit.split_plan(160, 4, 32, 64, H100_SMS) == (1, 4)
    assert kv_visit.split_plan(1024, 64, 32, 64, H100_SMS) == (1, 64)
    # a split boundary inside a block: 3 blocks of 200 keys, 4 tiles each
    n_split, tps = kv_visit.split_plan(8, 3, 200, 64, H100_SMS)
    starts = [keys[0] for keys in expand(n_split, tps, 3, 200, 64)]
    assert any(t > 0 for _, t in starts), starts
    # the instances' tiles
    assert [kv_visit.tile_keys(hd, torch.bfloat16) for hd in kv_visit.HEAD_DIMS] \
        == [64, 64, 64, 64]
    assert [kv_visit.tile_keys(hd, torch.float32) for hd in kv_visit.HEAD_DIMS] \
        == [64, 64, 32, 16]


# -- the model of the kernel's arithmetic --------------------------------------

def warp_of(instance, r):
    """The warp that takes key r of a tile."""
    return (r // 16) % WARPS if instance == "bfloat16" else r % WARPS


def partial(scores, vrows, neg, hd):
    """(m, l, acc) of one warp: m starts at the mask fill, as in the kernel."""
    if not scores:
        return torch.tensor(neg), torch.tensor(0.0), torch.zeros(hd)
    s = torch.stack(scores)
    m = torch.maximum(s.max(), torch.tensor(neg))
    p = torch.exp(s - m)
    return m, p.sum(), (p[:, None] * torch.stack(vrows)).sum(0)


def merge(parts):
    """Partials merged in the order given (the kernel's fixed order)."""
    mm = torch.stack([m for m, _, _ in parts]).max()
    ll = sum(l * torch.exp(m - mm) for m, l, _ in parts)
    aa = sum(a * torch.exp(m - mm) for m, _, a in parts)
    return mm, ll, aa


def kernel_model(q, kb, vb, ids, pos, instance, sms):
    """float32 model of csrc/kv_visit.cu at the wrapper's plan."""
    b_n, kv, g_n, hd = q.shape
    nb, bs = kb.shape[2], kb.shape[3]
    n_visit = ids.shape[2]
    tile = kv_visit.tile_keys(hd, getattr(torch, instance))
    n_split, tps = kv_visit.split_plan(b_n * kv, n_visit, bs, tile, sms)
    neg = numerics.mask_fill(torch.bfloat16)
    scale = hd ** -0.5
    out = torch.zeros_like(q)
    for b in range(b_n):
        p = int(pos[b])
        for h in range(kv):
            lst = [int(x) for x in ids[b, h]]
            uniform = not any(x >= 0 and x * bs <= p for x in lst)
            blocks = []
            for keys in expand(n_split, tps, n_visit, bs, tile):
                per_row = []
                for g in range(g_n):
                    warps = [([], []) for _ in range(WARPS)]
                    for j, t in keys:
                        raw = lst[j]
                        blk = min(max(raw, 0), nb - 1)
                        if not uniform and (raw < 0 or blk * bs + t > p):
                            continue      # past the valid prefix: not read
                        s = torch.tensor(neg) if uniform else \
                            (q[b, h, g] * kb[b, h, blk, t]).sum() * scale
                        w = warps[warp_of(instance, t % tile)]
                        w[0].append(s)
                        w[1].append(vb[b, h, blk, t])
                    per_row.append(merge([partial(s, v, neg, hd)
                                          for s, v in warps]))
                blocks.append(per_row)
            for g in range(g_n):
                _, ll, aa = merge([blk[g] for blk in blocks])
                out[b, h, g] = aa / torch.clamp(ll, min=1e-30)
    return out


def _case(b, kv, g, hd, nb, bs, n_visit, seed):
    """Lists with padding spread through them, a repeated id, positions
    inside a tile; (b, h) = (0, 0) lists only blocks past pos when pos
    allows (no valid key)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    kb = rng.normal(size=(b, kv, nb, bs, hd)).astype(np.float32)
    vb = rng.normal(size=(b, kv, nb, bs, hd)).astype(np.float32)
    ids = rng.integers(0, nb, size=(b, kv, n_visit)).astype(np.int64)
    ids[rng.random(ids.shape) < 0.3] = -1
    if n_visit > 1:
        ids[:, :, 1] = ids[:, :, 0]             # a repeated id
    pos = rng.integers(bs // 2, nb * bs, size=b).astype(np.int64)
    if nb > 2:
        pos[0] = bs // 3                        # only block 0 has valid keys
        ids[0, 0] = np.where(np.arange(n_visit) % 2, -1, nb - 1)
    return q, kb, vb, ids, pos


# (b, kv, g, hd, nb, bs, n_visit, sms)
MODEL_CASES = {
    "one_visit_bs33": (1, 2, 4, 32, 4, 33, 1, H100_SMS),
    "bs200_boundary_in_block": (2, 2, 3, 64, 4, 200, 3, H100_SMS),
    "more_splits_than_visits": (1, 1, 8, 32, 3, 300, 1, H100_SMS),
    "bkv_at_sms": (2, 4, 1, 32, 6, 40, 5, 8),
    "bkv_half_sms": (2, 4, 1, 32, 6, 40, 5, 16),
    "many_visits": (1, 2, 7, 32, 16, 16, 24, H100_SMS),
}


@pytest.mark.parametrize("instance", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_split_merge_model_matches_reference(case, instance):
    b, kv, g, hd, nb, bs, n_visit, sms = MODEL_CASES[case]
    q, kb, vb, ids, pos = _case(b, kv, g, hd, nb, bs, n_visit, seed=len(case))
    t = [torch.as_tensor(x) for x in (q, kb, vb, ids, pos)]
    got = kernel_model(*t, instance, sms).numpy()
    # the plan splits these lists (not one_visit_bs33's one tile, nor
    # bkv_at_sms's, with as many lists as SMs), and (0, 0) is the uniform
    # case
    tile = kv_visit.tile_keys(hd, getattr(torch, instance))
    n_split = kv_visit.split_plan(b * kv, n_visit, bs, tile, sms)[0]
    assert n_split > 1 or n_visit * -(-bs // tile) == 1 or b * kv >= sms
    assert not any(x >= 0 and x * bs <= pos[0] for x in ids[0, 0])
    j = (jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
         jnp.asarray(ids.astype(np.int32)), jnp.asarray(pos.astype(np.int32)))
    for want in (jax_kv_visit(*j, interpret=True), jax_kv_visit_ref(*j),
                 ref.kv_visit_attention_ref(*t)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL)


def test_model_merge_order_is_fixed():
    """The merge takes its partials in a fixed order: the same inputs give
    the same bits, and the one-split plan equals the many-split one within
    the float32 tolerance."""
    q, kb, vb, ids, pos = (torch.as_tensor(x) for x in
                           _case(1, 2, 4, 32, 6, 64, 6, seed=9))
    a = kernel_model(q, kb, vb, ids, pos, "bfloat16", H100_SMS)
    assert torch.equal(a, kernel_model(q, kb, vb, ids, pos, "bfloat16", H100_SMS))
    one = kernel_model(q, kb, vb, ids, pos, "bfloat16", sms=1)
    assert kv_visit.split_plan(2, 6, 64, 64, 1)[0] == 1
    torch.testing.assert_close(a, one, rtol=TOL, atol=TOL)
    assert math.isfinite(float(a.abs().max()))

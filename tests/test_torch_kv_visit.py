"""The port's block-visit decode attention and block selection against the
reference, on the CPU.

The port's op runs its plain version on CPU tensors; the reference runs its
Pallas kernel in interpret mode and its jnp oracle. Inputs come from numpy
seeds. Tolerances: float32 rtol = atol = 1e-5 (sums in another order);
bfloat16 2e-2 (as the reference's kernel tests use: both sides round the
output to bfloat16, and the interpret-mode kernel rounds its score inputs).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.kv_visit import kv_visit_attention as jax_kv_visit
from repro.kernels.ref import kv_visit_attention_ref as jax_kv_visit_ref
from repro_torch import numerics
from repro_torch.kernels import kv_visit, ops, ref
from repro_torch.models import layers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (b, kv, g, hd, nb, bs, n_visit): tests/test_kv_visit_kernel.py's shapes
SHAPES = [(2, 2, 4, 32, 4, 16, 2), (1, 1, 8, 64, 8, 32, 8),
          (2, 4, 2, 128, 4, 128, 3)]


def _case(b, kv, g, hd, nb, bs, n_visit, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    kb = rng.normal(size=(b, kv, nb, bs, hd)).astype(np.float32)
    vb = rng.normal(size=(b, kv, nb, bs, hd)).astype(np.float32)
    ids = np.full((b, kv, n_visit), -1, np.int32)
    for i in range(b):
        for h in range(kv):
            sel = rng.choice(nb, size=min(n_visit, nb), replace=False)
            ids[i, h, : sel.size] = sel
    pos = rng.integers(bs, nb * bs, size=b).astype(np.int32)
    return q, kb, vb, ids, pos


def _torch(arrays, dtype):
    q, kb, vb, ids, pos = arrays
    dt = getattr(torch, dtype)
    return (torch.as_tensor(q).to(dt), torch.as_tensor(kb).to(dt),
            torch.as_tensor(vb).to(dt), torch.as_tensor(ids),
            torch.as_tensor(pos))


def _jax(arrays, dtype):
    q, kb, vb, ids, pos = arrays
    dt = getattr(jnp, dtype)
    return (jnp.asarray(q, dt), jnp.asarray(kb, dt), jnp.asarray(vb, dt),
            jnp.asarray(ids), jnp.asarray(pos))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_reference_kernel_and_oracle(shape, dtype):
    arrays = _case(*shape)
    got = ops.kv_visit_attention(*_torch(arrays, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    args = _jax(arrays, dtype)
    tol = TOL[dtype]
    for want in (jax_kv_visit(*args, interpret=True), jax_kv_visit_ref(*args)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_visit_all_blocks_equals_dense_attention():
    """Visiting every block reproduces ordinary masked decode attention."""
    b, kv, g, hd, nb, bs = 2, 2, 3, 32, 4, 16
    q, kb, vb, _, pos = _case(b, kv, g, hd, nb, bs, nb, seed=1)
    ids = np.broadcast_to(np.arange(nb, dtype=np.int32), (b, kv, nb)).copy()
    got = ops.kv_visit_attention(*_torch((q, kb, vb, ids, pos), "float32"))
    k_flat = kb.reshape(b, kv, nb * bs, hd)
    v_flat = vb.reshape(b, kv, nb * bs, hd)
    s = np.einsum("bkgh,bkth->bkgt", q, k_flat) * hd ** -0.5
    valid = np.arange(nb * bs)[None, :] <= pos[:, None]
    s = np.where(valid[:, None, None, :], s, -1e38)
    w = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bkgt,bkth->bkgh", w / w.sum(-1, keepdims=True), v_flat)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def test_padding_ids_do_not_contribute():
    """-1 entries read block 0 and are masked: the result is unchanged."""
    q, kb, vb, _, pos = _case(1, 1, 2, 32, 4, 16, 2, seed=2)
    one = ops.kv_visit_attention(*_torch(
        (q, kb, vb, np.array([[[1, 2]]], np.int32), pos), "float32"))
    padded = ops.kv_visit_attention(*_torch(
        (q, kb, vb, np.array([[[1, 2, -1, -1]]], np.int32), pos), "float32"))
    torch.testing.assert_close(one, padded, rtol=1e-6, atol=1e-6)


def test_no_valid_key_gives_the_reference_uniform_average():
    """A list with no valid key: every key scores the finite fill, so the
    softmax is uniform over the listed keys (padding reads block 0)."""
    q, kb, vb, _, _ = _case(1, 2, 2, 32, 4, 16, 3, seed=3)
    ids = np.array([[[2, 3, -1], [3, -1, -1]]], np.int32)
    pos = np.array([5], np.int32)      # block 0 only: none of the listed
    got = ops.kv_visit_attention(*_torch((q, kb, vb, ids, pos), "float32"))
    want = jax_kv_visit(*_jax((q, kb, vb, ids, pos), "float32"), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ones = vb[0, 0, [2, 3, 0]].reshape(-1, 32).mean(0)
    np.testing.assert_allclose(got.numpy()[0, 0, 0], ones, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_token_major_view_equals_block_major_copy(dtype):
    """The model passes a block-major view of its token-major (B, S, KV, hd)
    cache; a contiguous block-major copy gives exactly the same result."""
    b, kv, g, hd, nb, bs = 2, 4, 2, 64, 8, 16
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    cache_k = torch.as_tensor(rng.normal(size=(b, nb * bs, kv, hd))).to(dt)
    cache_v = torch.as_tensor(rng.normal(size=(b, nb * bs, kv, hd))).to(dt)
    q = torch.as_tensor(rng.normal(size=(b, kv, g, hd))).to(dt)
    ids = torch.as_tensor(rng.integers(-1, nb, size=(b, kv, 3)))
    pos = torch.as_tensor([70, 127])

    def view(c):
        return c.view(b, nb, bs, kv, hd).permute(0, 3, 1, 2, 4)

    assert not view(cache_k).is_contiguous()
    strided = ops.kv_visit_attention(q, view(cache_k), view(cache_v), ids, pos)
    copied = ops.kv_visit_attention(q, view(cache_k).contiguous(),
                                    view(cache_v).contiguous(), ids, pos)
    assert torch.equal(strided, copied)


def test_backend_torch_equals_auto_on_cpu_and_counts_the_op():
    arrays = _torch(_case(*SHAPES[0]), "float32")
    ops.reset_counters()
    a = ops.kv_visit_attention(*arrays)
    b = ops.kv_visit_attention(*arrays, backend="torch")
    assert torch.equal(a, b)
    assert ops.counters() == {"kv_visit_attention": 2}
    assert ops.kernel_launches().get("kv_visit_attention", 0) == 0
    with pytest.raises(ValueError, match="unknown backend"):
        ops.kv_visit_attention(*arrays, backend="xla")


def test_wrapper_rejects_bad_shapes():
    q, kb, vb, ids, pos = _torch(_case(*SHAPES[0]), "float32")
    with pytest.raises(ValueError, match="k_blocks"):
        kv_visit.kv_visit_attention(q, kb[:, :1], vb, ids, pos)
    with pytest.raises(ValueError, match="block_ids"):
        kv_visit.kv_visit_attention(q, kb, vb, ids[..., :0], pos)
    with pytest.raises(ValueError, match="pos"):
        kv_visit.kv_visit_attention(q, kb, vb, ids, pos[:1])


def test_mask_fill_equals_reference():
    from repro import numerics as jax_numerics
    for dt in ("bfloat16", "float16", "float32"):
        assert numerics.mask_fill(getattr(torch, dt)) == \
            jax_numerics.mask_fill(getattr(jnp, dt))
    assert layers.NEG == numerics.mask_fill(torch.bfloat16)


def _bounds(seed, shape, n_ninf, n_ties):
    """Random bounds with -inf ties (blocks with no key yet), +inf (the
    block being written) and exactly tied finite values."""
    rng = np.random.default_rng(seed)
    ub = rng.normal(size=shape).astype(np.float32)
    flat = ub.reshape(-1, shape[-1])
    for row in flat:
        cols = rng.permutation(shape[-1])
        row[cols[:n_ninf]] = -np.inf
        row[cols[n_ninf]] = np.inf
        row[cols[n_ninf + 1: n_ninf + 1 + n_ties]] = 0.5
    return ub


@pytest.mark.parametrize("nb,keep,n_ninf,n_ties", [
    (8, 4, 6, 0),      # few blocks hold keys: -inf ties are selected
    (8, 4, 0, 4),      # finite ties across the boundary
    (64, 16, 40, 3),
    (4, 4, 2, 0),      # keep all
])
def test_block_selection_equals_lax_top_k(nb, keep, n_ninf, n_ties):
    ub = _bounds(nb + keep, (3, 2, nb), n_ninf, n_ties)
    got = layers.select_blocks(torch.as_tensor(ub), keep, 0)
    _, want = jax.lax.top_k(jnp.asarray(ub), keep)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,keep,groups", [(8, 4, 2), (64, 16, 16), (16, 3, 4)])
def test_grouped_block_selection_equals_reference(nb, keep, groups):
    """Top-(keep // groups) inside each contiguous block group, offsets
    added, as the reference's ``kv_prune_groups`` branch does."""
    ub = _bounds(groups, (2, 2, nb), nb // 3, 2)
    got = layers.select_blocks(torch.as_tensor(ub), keep, groups)
    nbg, kg = nb // groups, max(1, keep // groups)
    _, topg = jax.lax.top_k(jnp.asarray(ub).reshape(2, 2, groups, nbg), kg)
    want = (topg + (jnp.arange(groups) * nbg)[None, None, :, None]).reshape(
        2, 2, groups * kg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int64_and_int32_ids_and_positions_agree(dtype):
    """The top-k selection hands the op int64 ids and the server int32
    positions, the long-context decode int64 ones: every mix gives the same
    result (the kernel reads both widths; no cast)."""
    q, kb, vb, ids, pos = _torch(_case(*SHAPES[1], seed=5), dtype)
    want = ops.kv_visit_attention(q, kb, vb, ids.long(), pos.long())
    for i in (torch.int32, torch.int64):
        for p in (torch.int32, torch.int64):
            got = ops.kv_visit_attention(q, kb, vb, ids.to(i), pos.to(p))
            assert torch.equal(got, want)

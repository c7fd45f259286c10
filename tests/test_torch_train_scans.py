"""The port's training path of the scan families against the reference, on
the CPU: Mamba-2 (the chunked SSD) and RecurrentGemma (the RG-LRU scan, the
hybrid's (rec, rec, attn) groups and its tail of recurrent layers).

Reduced configs (d_model 128) of mamba2-780m (3 layers, 16 SSD heads of 16,
state 16, chunk 32) and recurrentgemma-2b (3 layers: one group; and 5: one
group and a tail of two, as ``recurrentgemma_2b@5``; local window 32), with
the reference's random weights carried across by
``models.convert.from_jax_params``; the same numpy tokens and labels (B =
2, S = 96: three SSD chunks, three local windows) go through the
reference's jitted ``forward``, ``loss_fn``, ``prefill`` and
``jax.value_and_grad`` and through the port's. The reference is jitted
once per (arch, dtype) and its outputs kept for the module
(``reference``).

Tolerances are ``tests/test_torch_train.py``'s, for the same reasons:
float32 logits 2e-5, losses 5e-6, gradients 1e-6, a train step's new
parameters 1e-5; bfloat16 logits 0.125, losses 0.005, gradients 2e-3 and
0.05 relative L2 per leaf. The modules alone (``ssd_chunked``,
``rglru_train``) are held to the float32 ones relative to the output's
largest magnitude, and in bfloat16 to two bfloat16 ulps of it. Measured
on these inputs (mamba2 / recurrentgemma 3 layers / 5 layers): float32
logits 4.1e-6 / 2.9e-6 / 2.9e-6, gradients 9.7e-8 / 3.7e-8 / 4.1e-8;
bfloat16 logits 0.058 / 0.035 / 0.047, losses 8.2e-4 / 6.8e-5 / 7.9e-4,
gradients 1.5e-3 / 8.5e-4 / 7.8e-4 and per leaf 0.043 / 0.015 / 0.019
relative L2 (mamba2's worst leaf is layer 0's ``A_log``).

Mamba-2's ``D`` is a float32 leaf that enters the bfloat16 forward through
a cast and a broadcast; the reference's gradient sums the broadcast's
bfloat16 products with bfloat16 adds on XLA's CPU backend, the port's in
float32 (``test_bf16_broadcast_gradient_sums_in_float32``). Against the
reference's sums the port's ``D`` gradients read up to 0.066 relative L2
(weights and batch from seed 2; 0.058 at seed 6), so the bfloat16 gradient
test holds each ``D`` against the float64 sum of the reference's own
bfloat16 products instead (``reference_d_sums``): 0.034 at the tests'
seeds, at most 0.049 over weight and batch seeds 1-6 (ROADMAP section 3).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models.params import Param, split_tree
from repro.models.registry import build_model as jax_build_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.models import rglru, ssm, transformer
from repro_torch.models.convert import from_jax_params, to_tensor
from repro_torch.models.params import leaves, unflatten
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import vocab_padded
from repro_torch.train import (CheckpointManager, OptConfig,
                               SimulatedPreemption, Trainer, TrainerConfig,
                               init_opt_state, make_train_step)
from repro_torch.train.train_step import _value_and_grad

F32_ATOL, F32_LOSS_ATOL = 2e-5, 5e-6
BF16_ATOL, BF16_LOSS_ATOL = 0.125, 0.005
GRAD_ATOL, STEP_ATOL = 1e-6, 1e-5
BF16_GRAD_ATOL, BF16_GRAD_REL = 2e-3, 0.05
# the modules alone: float32 relative to the largest |output|; bfloat16 two
# ulps (2 x 2^-8) of it
F32_REL, BF16_REL = 2e-6, 2.0 ** -7
B, S = 2, 96
SSM, HYBRID = "mamba2_780m", "recurrentgemma_2b"
HYBRID5 = "recurrentgemma_2b@5"
ARCHS = [SSM, HYBRID, HYBRID5]
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype="float32", **kw):
    """(reference config, port config) of ``arch``, reduced; ``name@n``
    sets n layers."""
    name, _, layers = arch.partition("@")
    if layers:
        kw = {"n_layers": int(layers), **kw}
    return (jax_get_config(name).reduced().replace(param_dtype=dtype, **kw),
            get_config(name).reduced().replace(param_dtype=dtype, **kw))


def _to_port(jtree, cfg):
    return from_jax_params(jax.tree.map(np.asarray, split_tree(jtree)[0]),
                           cfg, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs, beside
    XLA's thread pool (``tests/test_torch_train_families.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weights(jcfg, cfg, seed=1):
    """The reference's random weights and their port copy, kept for the
    module: no test writes to them."""
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jp, _to_port(jp, cfg)


def _batch(cfg, seed=0, seq=S, batch=B):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    """A reference array as a port tensor, bit for bit."""
    return to_tensor(np.asarray(a), "cpu")


@functools.lru_cache(maxsize=None)
def reference(arch, dtype):
    """The reference's outputs on ``_batch``, jitted once: logits, total
    loss, loss, aux loss, prefill (both ``prefill_last_only`` settings) and
    every gradient, carried across to the port's tree."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, _ = _weights(jcfg, cfg)
    model = jax_build_model(jcfg)
    last = jax_build_model(jcfg.replace(prefill_last_only=True))

    @jax.jit
    def run(p, b):
        (total, metrics), grads = jax.value_and_grad(
            model.loss_fn, has_aux=True)(p, b)
        return (model.forward(p, b)[0], total, metrics,
                model.prefill(p, b)[0], last.prefill(p, b)[0], grads)

    logits, total, metrics, pre, pre_last, grads = run(
        jp, _jax_batch(_batch(cfg)))
    return {"logits": np.asarray(logits, np.float32), "total": float(total),
            "loss": float(metrics["loss"]),
            "aux": float(metrics["aux_loss"]),
            "prefill": np.asarray(pre, np.float32),
            "prefill_last": np.asarray(pre_last, np.float32),
            "grads": _to_port(grads, cfg)}


class _Products:
    """Stands for the stacked value of Mamba-2's ``D`` in the reference's
    unrolled layer loop: the loop's ``value[i]`` gives layer i's stand-in,
    and that one's ``[None, None, :, None]`` (``ssm_train``'s broadcast)
    gives the layer's (B, L, H, P) array, so that the gradient holds each
    product of the broadcast apart."""

    def __init__(self, full, layer=False):
        self.full, self.layer = full, layer

    def __getitem__(self, idx):
        return self.full if self.layer else _Products(self.full[idx], True)


@functools.lru_cache(maxsize=None)
def reference_d_sums(arch):
    """(layers, H) float64 sums over (B, L, P) of the bfloat16 products
    that the reference's gradient of each layer's ``D`` adds up: its
    bfloat16 ``loss_fn`` on ``_batch``, with the layers unrolled and no
    remat so that ``D``'s value can be a ``_Products``, differentiated by
    the broadcast (B, L, H, P) array, which is summed here in float64."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jp, _ = _weights(jcfg, cfg)
    model = jax_build_model(jcfg.replace(scan_layers=False, remat="none"))
    d = jp["layers"]["ssm"]["D"]
    n, h = d.value.shape
    full = jnp.broadcast_to(d.value[:, None, None, :, None],
                            (n, B, S, h, cfg.ssm.head_dim))
    batch = _jax_batch(_batch(cfg))

    def loss(full):
        ssm_p = {**jp["layers"]["ssm"], "D": Param(_Products(full), d.axes)}
        tree = {**jp, "layers": {**jp["layers"], "ssm": ssm_p}}
        return model.loss_fn(tree, batch)[0]
    products = np.asarray(jax.jit(jax.grad(loss))(full), np.float64)
    return products.sum(axis=(1, 2, 4))


def _model(cfg, **kw):
    return build_model(cfg.replace(**kw), device="cpu")


def _close(got, want, dtype):
    """Within ``F32_REL`` / ``BF16_REL`` of the largest |want|."""
    got, want = _np(got), np.asarray(want, np.float32)
    rel = F32_REL if dtype == "float32" else BF16_REL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# the modules alone
# ---------------------------------------------------------------------------
def _ssd_inputs(nc, seed=0, b=2, chunk=32, h=16, n=16, p=16):
    """Random SSD inputs of ``nc`` chunks: x, positive dt (a softplus), the
    reduced config's A = -linspace(0.5, 1), B and C per head."""
    rng = np.random.default_rng(seed)
    l = nc * chunk
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32),
            -np.linspace(0.5, 1.0, h).astype(np.float32),
            rng.normal(size=(b, l, h, n)).astype(np.float32),
            rng.normal(size=(b, l, h, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nc", [1, 3, 4])
def test_ssd_chunked_matches_reference(nc, dtype):
    """y and the final state of ``ssd_chunked`` at 1, 3 and 4 chunks of 32
    against the reference's on the same inputs (x, dt, B, C in ``dtype``, A
    float32), both in ``dtype``."""
    xh, dth, a, bh, ch = _ssd_inputs(nc)
    jdt = jnp.dtype(dtype)
    ins = [jnp.asarray(v, jdt) for v in (xh, dth)] + [jnp.asarray(a)] + [
        jnp.asarray(v, jdt) for v in (bh, ch)]
    jy, js = jax.jit(jax_ssm.ssd_chunked, static_argnums=5)(*ins, 32)
    y, s = ssm.ssd_chunked(*[_t(v) for v in ins], 32)
    assert y.dtype == s.dtype == getattr(torch, dtype)
    assert y.shape == (2, nc * 32, 16, 16) and s.shape == (2, 16, 16, 16)
    _close(y, jy, dtype)
    _close(s, js, dtype)


def test_ssd_chunked_equals_the_recurrence():
    """float64 inputs: ``ssd_chunked`` over 3 chunks equals the
    step-by-step recurrence of ``ssm_decode`` (S_t = exp(dt_t A) S_{t-1} +
    dt_t x_t B_t; y_t = C_t S_t), state included, within 1e-6 of the
    largest |y| (the decays are computed in float32, as the reference's).
    """
    xh, dth, a, bh, ch = (torch.as_tensor(v, dtype=torch.float64)
                          for v in _ssd_inputs(3, seed=1))
    y, s_final = ssm.ssd_chunked(xh, dth, a, bh, ch, 32)
    s = torch.zeros((2, 16, 16, 16), dtype=torch.float64)
    ys = []
    for t in range(xh.shape[1]):
        da = torch.exp(dth[:, t] * a)[..., None, None]
        s = s * da + (xh[:, t] * dth[:, t, :, None])[..., None] \
            * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], s))
    ys = torch.stack(ys, 1)
    torch.testing.assert_close(y, ys, rtol=0,
                               atol=1e-6 * float(ys.abs().max()))
    torch.testing.assert_close(s_final, s, rtol=0,
                               atol=1e-6 * float(s.abs().max()))


def test_ssd_chunk_must_divide_the_length():
    xh, dth, a, bh, ch = (torch.as_tensor(v) for v in _ssd_inputs(1))
    with pytest.raises(ValueError, match="not a multiple"):
        ssm.ssd_chunked(xh, dth, a, bh, ch, 24)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_dconv_matches_reference(dtype):
    """The sequence form's depthwise conv, tap by tap in ``dtype``."""
    rng = np.random.default_rng(2)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(2, S, 64)), jdt)
    w = jnp.asarray(0.5 * rng.normal(size=(4, 64)), jdt)
    want = jax.jit(jax_ssm._causal_dconv)(x, w)
    got = ssm._causal_dconv(_t(x), _t(w))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def _rglru(dtype, seed=3):
    jcfg, cfg = _cfgs(HYBRID, dtype)
    jp = jax_rglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: _t(v) for k, v in jax.tree.map(np.asarray,
                                            split_tree(jp)[0]).items()}
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return jcfg, cfg, jp, tp, jnp.asarray(x, jnp.dtype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_train_matches_reference(dtype):
    """``rglru_train`` (the in-projection, the conv, the gates, the scan,
    the gelu gate, the out-projection) against the reference's."""
    jcfg, cfg, jp, tp, x = _rglru(dtype)
    want = jax.jit(lambda p, x: jax_rglru.rglru_train(p, x, jcfg))(jp, x)
    got = rglru.rglru_train(tp, _t(x), cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, dtype)


def test_rglru_scan_equals_the_decode_update():
    """float32: the scan's h equals h_t = a_t h_{t-1} + b_t (``rglru_decode``'s
    update) step by step within 1e-6 of its largest |h|, and
    ``rglru_train``'s output equals ``rglru_decode`` run token by token."""
    _, cfg, _, tp, x = _rglru("float32")
    x = _t(x)
    u = ssm._causal_dconv(x @ tp["w_in"], tp["conv"])
    a, bx = rglru._gates(tp, u)
    _, h = rglru._associative_scan(rglru._combine, (a, bx), dim=1)
    assert h.dtype == torch.float32
    step = torch.zeros_like(bx[:, 0])
    loop = []
    for t in range(S):
        step = a[:, t] * step + bx[:, t]
        loop.append(step)
    loop = torch.stack(loop, 1)
    torch.testing.assert_close(h, loop, rtol=0,
                               atol=1e-6 * float(loop.abs().max()))
    state = rglru.rglru_init_state(cfg, B, torch.float32, "cpu")
    ys = []
    for t in range(S):
        y, state = rglru.rglru_decode(tp, x[:, t:t + 1], state, cfg)
        ys.append(y)
    want = torch.cat(ys, 1)
    torch.testing.assert_close(rglru.rglru_train(tp, x, cfg), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 96, 97])
def test_associative_scan_depth_is_logarithmic(n):
    """The scan combines O(log n) times (2 per level of its recursion, no
    loop over the sequence), and equals a cumulative sum under ``+``."""
    calls = []

    def add(c1, c2):
        calls.append(1)
        return tuple(x + y for x, y in zip(c1, c2))
    x = torch.arange(1.0, n + 1, dtype=torch.float64)[None, :, None]
    (out,) = rglru._associative_scan(add, (x,), dim=1)
    torch.testing.assert_close(out, torch.cumsum(x, 1), rtol=0, atol=0)
    assert len(calls) <= 2 * max(1, int(np.ceil(np.log2(n))))


def test_bf16_broadcast_gradient_sums_in_float32():
    """The gradient of a float32 parameter cast to bfloat16 and broadcast
    (Mamba-2's D skip, ``y + xh * D``): the port's autograd sums the
    broadcast axes in float32, within 0.5% of the float64 sum of the same
    bfloat16 products; the reference's (XLA's CPU backend) adds in
    bfloat16 and lands further off, which is why these leaves read the
    largest bfloat16 gradient errors above."""
    rng = np.random.default_rng(0)
    shape = (B, S, 16, 16)
    x = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    y = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)

    def f(d, x, y):
        xd = x * d.astype(jnp.bfloat16)[None, None, :, None]
        return jnp.sum(xd.astype(jnp.float32) * y.astype(jnp.float32))
    want = (np.asarray(x, np.float64) * np.asarray(y, np.float64)).sum(
        axis=(0, 1, 3))
    ref = np.asarray(jax.jit(jax.grad(f))(jnp.ones(16), x, y), np.float64)
    d = torch.ones(16, requires_grad=True)
    xd = _t(x) * d.to(torch.bfloat16)[None, None, :, None]
    (xd.float() * _t(y).float()).sum().backward()
    port_err = np.abs(d.grad.double().numpy() - want).max()
    ref_err = np.abs(ref - want).max()
    scale = np.abs(want).max()
    assert port_err <= 0.005 * scale
    assert port_err < ref_err, (port_err, ref_err, scale)


# ---------------------------------------------------------------------------
# forward / loss_fn / prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_match_reference(arch, dtype):
    """Logits, the cross-entropy, the (zero) aux loss, their sum, and the
    prefill logits of both ``prefill_last_only`` branches against the
    reference's."""
    jcfg, cfg = _cfgs(arch, dtype)
    _, tp = _weights(jcfg, cfg)
    want = reference(arch, dtype)
    model = _model(cfg)
    tb = _port_batch(_batch(cfg))
    with torch.no_grad():
        logits, aux = model.forward(tp, tb)
        total, metrics = model.loss_fn(tp, tb)
        pre, pre_aux = model.prefill(tp, tb)
        pre_last, _ = _model(cfg, prefill_last_only=True).prefill(tp, tb)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    latol = F32_LOSS_ATOL if dtype == "float32" else BF16_LOSS_ATOL
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, vocab_padded(cfg))
    np.testing.assert_allclose(_np(logits), want["logits"], rtol=0, atol=atol)
    assert abs(float(metrics["loss"]) - want["loss"]) < latol
    assert abs(float(total) - want["total"]) < latol
    assert float(aux) == float(pre_aux) == want["aux"] == 0.0
    assert pre.shape == pre_last.shape == (B, 1, vocab_padded(cfg))
    np.testing.assert_allclose(_np(pre), want["prefill"], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(pre_last), want["prefill_last"], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(_np(pre), _np(logits)[:, -1:], rtol=0,
                               atol=atol)


def test_hybrid_tree_has_groups_and_a_tail():
    """The 5-layer hybrid is one (rec1, rec2, attn) group and a tail of two
    recurrent layers, as the reference's 26 = 8 x 3 + 2."""
    jcfg, cfg = _cfgs(HYBRID5)
    _, tp = _weights(jcfg, cfg)
    assert len(tp["groups"]) == 1 and len(tp["tail"]) == 2
    assert set(tp["groups"][0]) == {"rec1", "rec2", "attn"}
    assert "layers" not in tp


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(arch, dtype):
    """Every parameter's gradient of loss_fn against ``jax.value_and_grad``:
    float32 within ``GRAD_ATOL``; bfloat16 within ``BF16_GRAD_ATOL`` and
    ``BF16_GRAD_REL`` relative L2 per leaf, Mamba-2's ``D`` against the
    float64 sum of the reference's bfloat16 products
    (``reference_d_sums``) in place of the reference's bfloat16 sum."""
    jcfg, cfg = _cfgs(arch, dtype)
    _, tp = _weights(jcfg, cfg)
    want = reference(arch, dtype)
    total, _, got = _value_and_grad(_model(cfg), tp, _port_batch(_batch(cfg)))
    latol = F32_LOSS_ATOL if dtype == "float32" else BF16_LOSS_ATOL
    assert abs(float(total) - want["total"]) < latol
    assert len(got) == len(list(leaves(want["grads"])))
    d_sums = {}
    if dtype == "bfloat16" and cfg.family == "ssm":
        d_sums = {id(layer["ssm"]["D"]): row for layer, row in
                  zip(tp["layers"], reference_d_sums(arch))}
    for p, g, w in zip(leaves(tp), got, leaves(want["grads"])):
        assert g.shape == w.shape and g.dtype == w.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=GRAD_ATOL)
            continue
        if id(p) in d_sums:
            w = d_sums.pop(id(p))
        else:
            w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=BF16_GRAD_ATOL)
        norm = np.linalg.norm(w)
        if norm:
            err = np.linalg.norm(_np(g) - w) / norm
            assert err <= BF16_GRAD_REL, err
        else:
            assert not np.any(_np(g))
    assert not d_sums       # every D was met


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """cfg.remat="full": the loss and every gradient equal to no remat's
    bit for bit."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg))
    (t0, _, g0), (t1, _, g1) = [
        _value_and_grad(_model(cfg, remat=remat), tp, tb)
        for remat in ("none", "full")]
    assert torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_checkpoints_whole_groups(arch, monkeypatch):
    """Under grad, remat checkpoints once per Mamba-2 layer, once per
    hybrid group (rec1, rec2 and attn together, as the reference's remat of
    the group body) and once per tail layer; never under no_grad."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg, seq=32))
    model = _model(cfg, remat="full")
    tp = unflatten(tp, [t.detach().requires_grad_(True) for t in leaves(tp)])
    seen = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        seen.append(1)
        return real(fn, *args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", counting)
    with torch.no_grad():
        model.forward(tp, tb)
    assert not seen
    model.loss_fn(tp, tb)[0].backward()
    n_groups, tail = divmod(cfg.n_layers, 3)
    want = n_groups + tail if cfg.family == "hybrid" else cfg.n_layers
    assert len(seen) == want


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One make_train_step step in float32: loss, total loss and gradient
    norm within 1e-5 relative, every new parameter and master weight within
    ``STEP_ATOL``."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    batch = _batch(cfg, seed=4)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg),
                                        JaxOptConfig(warmup_steps=10)))
    jp2, jopt2, jmet = jstep(jp, jax_init_opt_state(jp), _jax_batch(batch))
    step = make_train_step(_model(cfg), OptConfig(warmup_steps=10))
    tp2, opt2, met = step(tp, init_opt_state(tp), _port_batch(batch))
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    assert met["lr"] == float(jmet["lr"]) and opt2["step"] == 1
    for g, w in zip(leaves(tp2), leaves(_to_port(jp2, cfg))):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)
    masters = from_jax_params(jax.tree.map(np.asarray, jopt2["master"]),
                              cfg, "cpu")
    for g, w in zip(leaves(opt2["master"]), leaves(masters)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)


# ---------------------------------------------------------------------------
# prefill against decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch):
    """float32: prefill's last-token logits (the chunked SSD / the scan,
    the local attention over its window) equal the port's decode of the
    same prompt (the recurrences, the ring cache) within ``F32_ATOL``."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    toks = _port_batch(_batch(cfg, seed=5))["tokens"]
    model = _model(cfg)
    with torch.no_grad():
        pre, _ = model.prefill(tp, {"tokens": toks})
        cache = model.init_cache(B, S)
        for t in range(S):
            lg, cache = model.decode_step(
                tp, cache, toks[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(pre), _np(lg), rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# checkpoints and the Trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [SSM, HYBRID5])
def test_checkpoint_restores_each_tree_bit_for_bit(arch, tmp_path):
    """The parameters and AdamW state after one bfloat16 step (the
    hybrid's nested ``groups`` / ``tail`` lists) save and restore with
    equal dtypes, shapes and bits."""
    _, cfg = _cfgs(arch, "bfloat16")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tp, opt, _ = make_train_step(model, OptConfig())(
        params, init_opt_state(params), _port_batch(_batch(cfg, seq=32)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": tp, "opt": opt, "step": np.asarray(1)})
    like = {"params": model.init(torch.Generator().manual_seed(1)),
            "opt": init_opt_state(params), "step": np.asarray(0)}
    out = mgr.restore(1, like)
    got, want = list(leaves(out["params"])), list(leaves(tp))
    assert len(got) == len(want) > 0
    for a, b in zip([*got, *leaves(out["opt"])], [*want, *leaves(opt)]):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert int(out["step"]) == 1


@pytest.mark.parametrize("arch", [SSM, HYBRID5])
def test_trainer_preemption_resume_is_exact(arch, tmp_path):
    """The Trainer on the MDRQ-filtered pipeline (seq 64: two SSD chunks,
    two local windows): the loss falls over 12 steps, and a preemption at
    step 7 with checkpoints every 5 steps ends with the losses and
    parameters of an uninterrupted run, bit for bit."""
    _, cfg = _cfgs(arch, "bfloat16")
    model = build_model(cfg, device="cpu")
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=64, global_batch=4,
                                            n_pool=1024, seed=0),
                                 device="cpu")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
    fail = {"n": 0}

    def hook(step):
        if step == 7 and fail["n"] == 0:
            fail["n"] += 1
            raise SimulatedPreemption()

    runs = []
    for name, every, fh in (("a", 5, hook), ("b", 100, None)):
        tr = Trainer(model, pipe, opt, str(tmp_path / name), TrainerConfig(
            num_steps=12, ckpt_every=every, log_every=1), failure_hook=fh,
            device="cpu")
        tr.init_state()
        runs.append((tr, {r["step"]: r["loss"] for r in tr.run()}))
    (a, la), (b, lb) = runs
    assert fail["n"] == 1 and a.ckpt.all_steps() == [5, 10]
    assert la[12] < la[1]
    assert la[12] == lb[12]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.params),
                                                 leaves(b.params)))

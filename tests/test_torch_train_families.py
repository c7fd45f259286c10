"""The port's training path of the MoE families and the encoder-decoder
against the reference, on the CPU.

Reduced configs (3 decoder layers, d_model 128, head_dim 32) of
deepseek-moe-16b (8 experts top-2 plus one shared expert), arctic-480b (8
experts top-2 plus the dense residual FFN) and seamless-m4t-large-v2 (2
encoder and 3 decoder layers), with the reference's random weights carried
across by ``models.convert.from_jax_params``; the same numpy tokens,
labels and (the encoder-decoder's) stub frame embeddings of ``max(8, S //
4)`` frames, as the reference's ``_token_specs`` sizes them, go through the
reference's jitted ``forward``, ``loss_fn``, ``prefill`` and
``jax.value_and_grad`` and through the port's. The reference is jitted
once per (arch, dtype) and its outputs kept for the module (``reference``).

Tolerances are ``tests/test_torch_train.py``'s, for the same reasons:
float32 logits 2e-5, losses (the cross-entropy, the aux loss and their
sum) 5e-6, gradients 1e-6, a train step's new parameters 1e-5; bfloat16
logits 0.125, losses 0.005, gradients 2e-3 and 0.05 relative L2 per leaf.

MoE routing in bfloat16: router inputs one bfloat16 ulp apart can swap a
near-tied k-th and (k+1)-th expert, which moves the layer's output by a
whole expert's share (``tests/test_torch_lm_families.py``'s docstring). So
the bfloat16 MoE cases run a zero router, every probability tied, and both
sides route by the tie rule (the lowest ids); float32 runs the real
routers, and the port's expert ids are checked against a float64 top-k of
the same router inputs wherever its k-th and (k+1)-th probabilities are
apart. At S = 80, E = 8, k = 2 the capacity is ``int(1.25 * 2 * 80 / 8)``
= 25 against a mean load of 20, so choices do drop
(``test_capacity_drop_is_exercised`` counts them on these inputs).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.params import Param, split_tree
from repro.models.registry import build_model as jax_build_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params
from repro_torch.models.encdec import EncDecLM
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
B, S = 2, 80
MOE_ARCHS = ["deepseek_moe_16b", "arctic_480b"]
ENCDEC = "seamless_m4t_large_v2"
ARCHS = MOE_ARCHS + [ENCDEC]
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype="float32", **kw):
    return (jax_get_config(arch).reduced().replace(param_dtype=dtype, **kw),
            get_config(arch).reduced().replace(param_dtype=dtype, **kw))


def _zero_router(jp):
    r = jp["layers"]["moe"]["router"]
    jp["layers"]["moe"]["router"] = Param(jnp.zeros_like(r.value), r.axes)
    return jp


def _to_port(jtree, cfg):
    return from_jax_params(jax.tree.map(np.asarray, split_tree(jtree)[0]),
                           cfg, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: beside
    XLA's thread pool, torch's default of one thread per core slowed these
    small ops ~300x on an 8-core host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _weights(jcfg, cfg, seed=1):
    """The reference's random weights and their port copy; a zero router
    for a bfloat16 MoE (the module docstring). Kept for the module: no
    test writes to them."""
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    if jcfg.family == "moe" and jcfg.param_dtype == "bfloat16":
        jp = _zero_router(jp)
    return jp, _to_port(jp, cfg)


def enc_len(seq: int) -> int:
    """Stub frames per sequence: the reference's ``_token_specs``."""
    return max(8, seq // 4)


def _batch(cfg, seed=0, seq=S, batch=B):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
               np.int32)}
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.normal(
            size=(batch, enc_len(seq), cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def reference(arch, dtype):
    """The reference's outputs on ``_batch``, jitted once: logits, total
    loss, loss, aux loss, prefill (both ``prefill_last_only`` settings for a
    decoder) and every gradient, carried across to the port's tree."""
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


def _model(cfg, **kw):
    return build_model(cfg.replace(**kw), device="cpu")


# ---------------------------------------------------------------------------
# forward / loss_fn / prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_match_reference(arch, dtype):
    """Logits, the cross-entropy and the aux loss each, their sum, and the
    prefill logits (for a decoder both ``prefill_last_only`` branches)
    against the reference's; the MoE aux loss positive, the
    encoder-decoder's zero."""
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
    assert abs(float(metrics["aux_loss"]) - want["aux"]) < latol
    assert abs(float(total) - want["total"]) < latol
    assert float(aux) == float(metrics["aux_loss"]) == float(pre_aux)
    if cfg.family == "moe":
        assert float(aux) > 0.0
    else:
        assert float(aux) == 0.0
    assert pre.shape == pre_last.shape == (B, 1, vocab_padded(cfg))
    np.testing.assert_allclose(_np(pre), want["prefill"], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(pre_last), want["prefill_last"], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(_np(pre), _np(logits)[:, -1:], rtol=0,
                               atol=atol)


def _routes(model, tp, tb):
    """Every ``moe.route`` call of one forward: (router probabilities,
    expert ids, router input)."""
    calls = []
    route = moe.route

    def recording(p, x, cfg):
        probs, gates, idx = route(p, x, cfg)
        calls.append((probs, idx, x, p["router"]))
        return probs, gates, idx
    moe.route = recording
    try:
        with torch.no_grad():
            model.forward(tp, tb)
    finally:
        moe.route = route
    return calls


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_float32_routes_follow_the_router(arch):
    """float32: each layer's expert ids are the top-k of a float64 softmax
    of the same router inputs wherever its k-th and (k+1)-th probabilities
    are more than 1e-6 apart (the rest are near-ties, none of which may
    exceed 1% of the choices), in descending probability order."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    calls = _routes(_model(cfg), tp, _port_batch(_batch(cfg)))
    k = cfg.moe.top_k
    assert len(calls) == cfg.n_layers
    for probs, idx, x, router in calls:
        p64 = torch.softmax(x.double() @ router.double(), dim=-1)
        top = torch.sort(p64, dim=-1, descending=True)
        decided = (top.values[..., k - 1] - top.values[..., k]) > 1e-6
        assert float((~decided).float().mean()) <= 0.01
        assert torch.equal(idx[decided], top.indices[..., :k][decided])
        ordered = torch.take_along_dim(probs, idx, dim=-1)
        assert bool((ordered[..., :-1] >= ordered[..., 1:]).all())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_drop_is_exercised(arch):
    """On these inputs (float32, real routers) some (token, choice) pairs
    queue past their expert's capacity in some layer, so the drop path is
    held by the parity tests; the count is that of ``moe_apply``'s rule."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    calls = _routes(_model(cfg), tp, _port_batch(_batch(cfg)))
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = max(1, int(cfg.moe.capacity_factor * k * S / e))
    assert cap == 25
    dropped = 0
    for _, idx, _, _ in calls:
        flat = idx.reshape(B, S * k)      # (token, choice) in token order
        for b in range(B):
            load: dict[int, int] = {}
            for ex in flat[b].tolist():
                dropped += load.get(ex, 0) >= cap
                load[ex] = load.get(ex, 0) + 1
    assert dropped > 0


def test_bfloat16_zero_router_ties_route_to_the_lowest_ids():
    """The bfloat16 cases' zero router: every token takes experts 0..k-1,
    and all but ``cap`` of them drop at each."""
    jcfg, cfg = _cfgs("deepseek_moe_16b", "bfloat16")
    _, tp = _weights(jcfg, cfg)
    calls = _routes(_model(cfg), tp, _port_batch(_batch(cfg)))
    k = cfg.moe.top_k
    for _, idx, _, router in calls:
        assert not bool(router.any())
        assert bool((idx == torch.arange(k)).all())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(arch, dtype):
    """Every parameter's gradient of loss_fn (the aux loss included)
    against ``jax.value_and_grad``: float32 within ``GRAD_ATOL``; bfloat16
    within ``BF16_GRAD_ATOL`` and ``BF16_GRAD_REL`` relative L2 per leaf."""
    jcfg, cfg = _cfgs(arch, dtype)
    _, tp = _weights(jcfg, cfg)
    want = reference(arch, dtype)
    total, metrics, got = _value_and_grad(_model(cfg), tp,
                                          _port_batch(_batch(cfg)))
    latol = F32_LOSS_ATOL if dtype == "float32" else BF16_LOSS_ATOL
    assert abs(float(total) - want["total"]) < latol
    assert len(got) == len(list(leaves(want["grads"])))
    for g, w in zip(got, leaves(want["grads"])):
        assert g.shape == w.shape and g.dtype == w.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=GRAD_ATOL)
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=BF16_GRAD_ATOL)
        norm = np.linalg.norm(_np(w))
        if norm:
            err = np.linalg.norm(_np(g) - _np(w)) / norm
            assert err <= BF16_GRAD_REL, err
        else:
            assert not np.any(_np(g))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """cfg.remat="full": each MoE layer, encoder layer and decoder layer
    under torch.utils.checkpoint; the loss, aux loss and every gradient
    equal to no remat's bit for bit."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg))
    out = [_value_and_grad(_model(cfg, remat=remat), tp, tb)
           for remat in ("none", "full")]
    (t0, m0, g0), (t1, m1, g1) = out
    assert torch.equal(t0, t1)
    assert torch.equal(m0["aux_loss"], m1["aux_loss"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_checkpoints_only_under_grad(monkeypatch):
    """The checkpointed body runs once per layer (encoder and decoder)
    while grad is enabled, and never under no_grad, where serving runs."""
    from repro_torch.models import transformer
    jcfg, cfg = _cfgs(ENCDEC)
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg))
    model = _model(cfg, remat="full")
    live = [t.detach().requires_grad_(True) for t in leaves(tp)]
    tp = unflatten(tp, live)
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
    assert len(seen) == cfg.encoder_layers + cfg.n_layers


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data_batch():
    """Batch 0 of the pipeline ``tests/test_torch_train.py`` reads."""
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=512, seq_len=32,
                                            global_batch=8, n_pool=1024,
                                            seed=1), device="cpu")
    return pipe.batch(0)


@pytest.mark.parametrize("accum", [1, 4])
def test_moe_train_step_matches_reference(data_batch, accum):
    """One make_train_step step of reduced deepseek-moe-16b in float32:
    loss, aux loss, total loss and gradient norm within 1e-5 relative,
    every new parameter and master weight within ``STEP_ATOL``. Under
    grad_accum the metric ``aux_loss`` is zero and ``loss`` the mean of the
    microbatches' totals, as the reference's."""
    jcfg, cfg = _cfgs("deepseek_moe_16b")
    jp, tp = _weights(jcfg, cfg)
    jstep = jax.jit(jax_make_train_step(
        jax_build_model(jcfg), JaxOptConfig(warmup_steps=10),
        grad_accum=accum))
    jp2, jopt2, jmet = jstep(jp, jax_init_opt_state(jp),
                             _jax_batch(data_batch))
    step = make_train_step(_model(cfg), OptConfig(warmup_steps=10),
                           grad_accum=accum)
    tp2, opt2, met = step(tp, init_opt_state(tp),
                          {k: torch.as_tensor(v) for k, v in
                           data_batch.items()})
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    if accum == 1:
        assert float(met["aux_loss"]) > 0.0
        assert float(met["aux_loss"]) == pytest.approx(
            float(jmet["aux_loss"]), rel=1e-5)
    else:
        assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    assert met["lr"] == float(jmet["lr"]) and opt2["step"] == 1
    for g, w in zip(leaves(tp2), leaves(_to_port(jp2, cfg))):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)
    masters = from_jax_params(jax.tree.map(np.asarray, jopt2["master"]),
                              cfg, "cpu")
    for g, w in zip(leaves(opt2["master"]), leaves(masters)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)


def test_encdec_microbatches_split_the_frames():
    """grad_accum 2 on a batch with ``enc_embeds``: each microbatch takes
    its rows' frames, so the step's loss is the mean of the two halves'."""
    jcfg, cfg = _cfgs(ENCDEC)
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg, seq=16, batch=4))
    model = _model(cfg)
    halves = [float(model.loss_fn(tp, {k: v[i:i + 2] for k, v in
                                       tb.items()})[0]) for i in (0, 2)]
    _, _, met = make_train_step(model, OptConfig(), grad_accum=2)(
        tp, init_opt_state(tp), tb)
    assert float(met["loss"]) == pytest.approx(np.mean(halves), rel=1e-6)


# ---------------------------------------------------------------------------
# prefill against decode (the encoder-decoder)
# ---------------------------------------------------------------------------
def test_encdec_prefill_matches_decode():
    """float32: prefill's last-token logits equal a decode of the same
    prompt over the cross cache of the same frames within ``F32_ATOL``.
    (Not for MoE: decode routes one token, so nothing drops, while prefill
    over the prompt can drop.)"""
    jcfg, cfg = _cfgs(ENCDEC)
    _, tp = _weights(jcfg, cfg)
    batch = _port_batch(_batch(cfg, seq=24))
    model = _model(cfg)
    with torch.no_grad():
        pre, _ = model.prefill(tp, batch)
        cache = model.init_cache(B, 24, enc_len=enc_len(24))
        model.fill_cross_cache(tp, cache, batch["enc_embeds"])
        for t in range(24):
            lg, cache = model.decode_step(
                tp, cache, batch["tokens"][:, t:t + 1],
                torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(pre), _np(lg), rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# checkpoints and the Trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_each_tree_bit_for_bit(arch, tmp_path):
    """The parameters and AdamW state after one bfloat16 step (nested
    expert / shared / dense-residual dicts, encoder and decoder lists) save
    and restore with equal dtypes, shapes and bits."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tp, opt, _ = make_train_step(model, OptConfig())(
        params, init_opt_state(params), _port_batch(_batch(cfg, seq=16)))
    state = {"params": tp, "opt": opt, "step": np.asarray(1)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
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


class FramedPipeline:
    """The pipeline's tokens and labels with stub frame embeddings of
    ``enc_len(seq)`` frames beside them, drawn from numpy seed (seed,
    step)."""

    def __init__(self, pipe, d_model: int, seed: int = 0):
        self.pipe, self.d_model, self.seed = pipe, d_model, seed

    def batch(self, step: int) -> dict:
        out = self.pipe.batch(step)
        b, s = out["tokens"].shape
        rng = np.random.default_rng((self.seed, step))
        out["enc_embeds"] = rng.normal(
            size=(b, enc_len(s), self.d_model)).astype(np.float32)
        return out


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", ENCDEC])
def test_trainer_preemption_resume_is_exact(arch, tmp_path):
    """The Trainer on the MDRQ-filtered pipeline (the encoder-decoder's
    with stub frames): the loss falls over 12 steps, and a preemption at
    step 7 with checkpoints every 5 steps ends with the losses and
    parameters of an uninterrupted run, bit for bit."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=32, global_batch=4,
                                            n_pool=1024, seed=0),
                                 device="cpu")
    if isinstance(model, EncDecLM):
        pipe = FramedPipeline(pipe, cfg.d_model)
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

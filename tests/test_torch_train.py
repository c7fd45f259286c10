"""The port's training path against the reference, on the CPU.

Reduced configs (2-3 layers, d_model 128, head_dim 32) of the dense and vlm
families — smollm-360m, qwen3-8b (qk-norm), h2o-danube-1.8b (its reduced
64-token sliding window, a sequence of 80 tokens and query chunks of 40),
phi3-medium-14b and llava-next-34b (8 prefix embeddings) — with the
reference's random weights carried across by
``models.convert.from_jax_params``; the same numpy tokens, labels and
prefix embeddings go through the reference's jitted ``forward``,
``loss_fn`` and ``prefill`` (``prefill_last_only`` both ways) and the
port's. Gradients are held against ``jax.grad``, the optimizer
against the reference and against the numpy AdamW of
``tests/test_train.py``, one train step at ``grad_accum`` 1 and 4 against
the reference's; the checkpoint manager, the Trainer and both launchers
mirror ``tests/test_train.py``.

Tolerances, each set from the spread measured on these inputs (stated in
brackets) and stated where it is used:
  * float32 logits ``F32_ATOL`` = 2e-5 [2.9e-6; sums in another order],
    losses ``F32_LOSS_ATOL`` = 5e-6 [9.5e-7];
  * bfloat16 logits ``BF16_ATOL`` = 0.125 [0.0625: one bfloat16 ulp at
    smollm's largest logits (8.9), the two frameworks rounding to bfloat16
    at other places, as in decode], losses ``BF16_LOSS_ATOL`` = 0.005
    [1.2e-3];
  * float32 gradients ``GRAD_ATOL`` = 1e-6 [5.2e-8, gradients up to 0.07];
    bfloat16 gradients ``BF16_GRAD_ATOL`` = 2e-3 [7.3e-4] and, per leaf,
    a relative L2 error ``BF16_GRAD_REL`` = 0.05 [0.0185] (the two
    backward passes round to bfloat16 at other places);
  * a float32 train step's new parameters ``STEP_ATOL`` = 1e-5 [1.06e-6];
  * AdamW: rtol 1e-5, atol 1e-7 on the float32 master (the reference
    test's own), exact on the bfloat16 cast of the same master.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.params import Param, split_tree
from repro.models.registry import build_model as jax_build_model
from repro.train import adamw_update as jax_adamw_update
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import OptConfig as JaxOptConfig
from repro.train.optimizer import lr_at as jax_lr_at
from repro.train.train_step import quantize_int8 as jax_quantize_int8
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.params import leaves
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import vocab_padded
from repro_torch.serve.serve_step import make_prefill
from repro_torch.train import (CheckpointManager, OptConfig,
                               SimulatedPreemption, Trainer, TrainerConfig,
                               adamw_update, init_opt_state, make_train_step)
from repro_torch.train.optimizer import global_norm, lr_at
from repro_torch.train.train_step import quantize_int8

F32_ATOL, F32_LOSS_ATOL = 2e-5, 5e-6
BF16_ATOL, BF16_LOSS_ATOL = 0.125, 0.005
GRAD_ATOL, STEP_ATOL = 1e-6, 1e-5
BF16_GRAD_ATOL, BF16_GRAD_REL = 2e-3, 0.05
B, S = 2, 80
ARCHS = ["smollm_360m", "qwen3_8b", "h2o_danube_1_8b", "phi3_medium_14b",
         "llava_next_34b"]
# q_chunk 40 runs h2o-danube's attention in two query chunks
CHANGES = {"h2o_danube_1_8b": {"q_chunk": 40}}


def _cfgs(arch, dtype="float32", **kw):
    kw = {**CHANGES.get(arch, {}), **kw}
    return (jax_get_config(arch).reduced().replace(param_dtype=dtype, **kw),
            get_config(arch).reduced().replace(param_dtype=dtype, **kw))


def _weights(jcfg, cfg, seed=1):
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.tree.map(np.asarray, split_tree(jp)[0]),
                               cfg, "cpu")


def _batch(cfg, seed=0):
    """numpy batch: S positions in all, the prefix included."""
    rng = np.random.default_rng(seed)
    text = S - cfg.n_prefix_embeds
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def test_xent_loss_on_vocab_padded_logits():
    """Padded columns carry no mass: equal to the reference's within float32
    summation (1e-6), and to a numpy log-softmax over the real columns."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 7, 512)) * 4).astype(np.float32)
    logits[..., 500:] = 30.0        # padded columns larger than every real one
    labels = rng.integers(0, 500, (2, 7)).astype(np.int32)
    from repro.models.layers import xent_loss as jax_xent_loss
    want = float(jax_xent_loss(jnp.asarray(logits), jnp.asarray(labels), 500))
    got = layers.xent_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                           500)
    got32 = float(got)
    real = logits[..., :500].astype(np.float64)
    lse = np.log(np.exp(real - real.max(-1, keepdims=True)).sum(-1)) \
        + real.max(-1)
    gold = np.take_along_axis(real, labels[..., None], -1)[..., 0]
    assert abs(got32 - want) < 1e-6
    assert abs(got32 - float((lse - gold).mean())) < 1e-5
    assert got.dtype == torch.float32 and torch.isfinite(got)


# ---------------------------------------------------------------------------
# forward / loss_fn / prefill
# ---------------------------------------------------------------------------
def _jax_outputs(jcfg, jp, batch):
    model = jax_build_model(jcfg)
    last = jax_build_model(jcfg.replace(prefill_last_only=True))

    @jax.jit
    def run(p, b):
        return (model.forward(p, b)[0], model.loss_fn(p, b),
                model.prefill(p, b)[0], last.prefill(p, b)[0])

    logits, (total, metrics), pre, pre_last = run(jp, _jax_batch(batch))
    return (np.asarray(logits, np.float32), float(total),
            float(metrics["loss"]), np.asarray(pre, np.float32),
            np.asarray(pre_last, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_match_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, cfg)
    batch = _batch(cfg)
    w_logits, w_total, w_loss, w_pre, w_pre_last = _jax_outputs(jcfg, jp,
                                                                batch)
    model = build_model(cfg, device="cpu")
    tb = _port_batch(batch)
    with torch.no_grad():
        logits, aux = model.forward(tp, tb)
        total, metrics = model.loss_fn(tp, tb)
        pre, _ = make_prefill(model)(tp, tb)
        pre_last, _ = build_model(cfg.replace(prefill_last_only=True),
                                  device="cpu").prefill(tp, tb)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    latol = F32_LOSS_ATOL if dtype == "float32" else BF16_LOSS_ATOL
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, vocab_padded(cfg))
    np.testing.assert_allclose(_np(logits), w_logits, rtol=0, atol=atol)
    assert abs(float(metrics["loss"]) - w_loss) < latol
    assert abs(float(total) - w_total) < latol
    assert float(aux) == 0.0 and float(metrics["aux_loss"]) == 0.0
    assert pre.shape == pre_last.shape == (B, 1, vocab_padded(cfg))
    np.testing.assert_allclose(_np(pre), w_pre, rtol=0, atol=atol)
    np.testing.assert_allclose(_np(pre_last), w_pre_last, rtol=0, atol=atol)
    # both prefill branches: the last position of the full forward
    np.testing.assert_allclose(_np(pre_last), _np(logits)[:, -1:], rtol=0,
                               atol=atol)


def test_loss_is_taken_on_the_text_suffix():
    """llava's loss ignores the prefix positions: equal to xent_loss over
    the text logits alone."""
    jcfg, cfg = _cfgs("llava_next_34b")
    _, tp = _weights(jcfg, cfg)
    tb = _port_batch(_batch(cfg))
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits, _ = model.forward(tp, tb)
        _, metrics = model.loss_fn(tp, tb)
    want = layers.xent_loss(logits[:, cfg.n_prefix_embeds:], tb["labels"],
                            cfg.vocab_size)
    assert float(metrics["loss"]) == float(want)


def test_remat_changes_no_value():
    """cfg.remat="full" (per-layer torch.utils.checkpoint) gives the same
    loss and gradients bit for bit as no remat."""
    jcfg, cfg = _cfgs("qwen3_8b")
    _, tp = _weights(jcfg, cfg)
    batch = _port_batch(_batch(cfg))
    out = []
    for remat in ("none", "full"):
        model = build_model(cfg.replace(remat=remat), device="cpu")
        live = [p.detach().requires_grad_(True) for p in leaves(tp)]
        from repro_torch.models.params import unflatten
        total, _ = model.loss_fn(unflatten(tp, live), batch)
        out.append((total.detach(), torch.autograd.grad(total, live)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(arch, dtype):
    """Every parameter's gradient of loss_fn against jax.grad: in float32
    within ``GRAD_ATOL``; in bfloat16 within ``BF16_GRAD_ATOL`` and each
    leaf within ``BF16_GRAD_REL`` in relative L2 norm."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, cfg)
    batch = _batch(cfg)
    jmodel = jax_build_model(jcfg)
    jg = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))(
        jp, _jax_batch(batch))
    want = from_jax_params(jax.tree.map(np.asarray, split_tree(jg)[0]), cfg,
                           "cpu")
    from repro_torch.train.train_step import _value_and_grad
    _, _, got = _value_and_grad(build_model(cfg, device="cpu"), tp,
                                _port_batch(batch))
    assert len(got) == len(list(leaves(want)))
    for g, w in zip(got, leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=GRAD_ATOL)
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=BF16_GRAD_ATOL)
        err = np.linalg.norm(_np(g) - _np(w)) / np.linalg.norm(_np(w))
        assert err <= BF16_GRAD_REL, err


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_reference():
    """lr_at over 0..2 x decay_steps equals the reference's float32 value
    within two float32 ulps (numpy's and XLA's cos; 4 of the 201 steps
    differ, by up to 2.4e-7 relative)."""
    cfg = OptConfig(peak_lr=3e-4, warmup_steps=10, decay_steps=100,
                    min_lr_frac=0.1)
    jcfg = JaxOptConfig(peak_lr=3e-4, warmup_steps=10, decay_steps=100,
                        min_lr_frac=0.1)
    steps = np.arange(0, 201)
    got = np.array([lr_at(cfg, int(s)) for s in steps], np.float32)
    want = np.asarray(jax.vmap(lambda s: jax_lr_at(jcfg, s))(
        jnp.asarray(steps, jnp.int32)), np.float32)
    np.testing.assert_allclose(got, want, rtol=2 * 2 ** -23, atol=0)
    assert got[0] < got[9] <= 3e-4 and abs(got[-1] - 3e-5) < 1e-9
    assert all(isinstance(lr_at(cfg, s), float) for s in (0, 50))


def _np_adamw(w, g, m, v, step, cfg, clip_scale):
    """tests/test_train.py's numpy AdamW, with the clip applied to g."""
    lr = lr_at(cfg, step)
    g = g * clip_scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    upd = (m2 / (1 - cfg.b1 ** step)) / (np.sqrt(v2 / (1 - cfg.b2 ** step))
                                         + cfg.eps)
    return w - lr * (upd + cfg.weight_decay * w), m2, v2


def test_adamw_matches_reference_and_numpy_with_binding_clip():
    """Three steps on a bfloat16 matrix and a float32 vector with gradients
    whose norm (~7) the clip (0.5) binds: master, m, v within rtol 1e-5 /
    atol 1e-7 of the reference's and of numpy's, grad_norm and lr equal
    within float32, the new bfloat16 parameters the cast of the master."""
    kw = dict(grad_clip=0.5, warmup_steps=2, decay_steps=10)
    cfg, jcfg = OptConfig(**kw), JaxOptConfig(**kw)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    gs = [{"w": rng.normal(size=(32, 16)).astype(np.float32) * 0.3,
           "b": rng.normal(size=(16,)).astype(np.float32)}
          for _ in range(3)]
    tp = {"w": torch.as_tensor(w).to(torch.bfloat16), "b": torch.as_tensor(b)}
    jp = {"w": Param(jnp.asarray(w, jnp.bfloat16), (None, None)),
          "b": Param(jnp.asarray(b), (None,))}
    opt, jopt = init_opt_state(tp), jax_init_opt_state(jp)
    ref = {k: (np.asarray(jopt["master"][k]), 0.0, 0.0) for k in ("w", "b")}
    assert opt["master"]["b"].data_ptr() != tp["b"].data_ptr()  # a copy
    for step, g in enumerate(gs, 1):
        tp, opt, met = adamw_update(tp, {k: torch.as_tensor(v)
                                         for k, v in g.items()}, opt, cfg)
        jp, jopt, jmet = jax_adamw_update(jp, {k: jnp.asarray(v)
                                               for k, v in g.items()},
                                          jopt, jcfg)
        gnorm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                            for v in g.values()))
        scale = min(1.0, cfg.grad_clip / (gnorm + 1e-9))
        assert scale < 0.1                                  # the clip binds
        ref = {k: _np_adamw(*ref[k][:1], g[k], *ref[k][1:], step, cfg, scale)
               for k in ("w", "b")}
        assert opt["step"] == step == int(jopt["step"])
        assert abs(float(met["grad_norm"]) - gnorm) < 1e-5 * gnorm
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) \
            < 1e-6 * gnorm
        assert met["lr"] == float(jmet["lr"])
        for k in ("w", "b"):
            for name, i in (("master", 0), ("m", 1), ("v", 2)):
                got = opt[name][k].numpy()
                np.testing.assert_allclose(got, np.asarray(jopt[name][k]),
                                           rtol=1e-5, atol=1e-7)
                np.testing.assert_allclose(got, ref[k][i], rtol=1e-5,
                                           atol=1e-7)
    assert tp["w"].dtype == torch.bfloat16
    assert torch.equal(tp["w"], opt["master"]["w"].to(torch.bfloat16))
    assert torch.equal(tp["b"], opt["master"]["b"])


def test_grad_norm_of_a_tree():
    tree = {"a": [torch.full((3,), 2.0), torch.ones(4, dtype=torch.bfloat16)]}
    assert float(global_norm(tree)) == pytest.approx(4.0)


def test_int8_quantization_matches_reference():
    """Codes equal to the reference's, scale within float32 (1 ulp), and
    the reference test's bound on the relative error."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000,)).astype(np.float32) * 0.01
    q, s = quantize_int8(torch.as_tensor(g))
    jq, js = jax_quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=2 ** -23)
    rel = np.abs(q.numpy().astype(np.float32) * float(s) - g).max() \
        / np.abs(g).max()
    assert rel < 0.01


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data_batch():
    """Batch 0 of the pipeline the reference's grad-accum test reads."""
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=512, seq_len=32,
                                            global_batch=8, n_pool=1024,
                                            seed=1), device="cpu")
    return pipe.batch(0)


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 4),
                                         ("bfloat16", 1)])
def test_train_step_matches_reference(data_batch, dtype, accum):
    """One make_train_step step of reduced smollm-360m: loss and grad_norm
    within float32 summation (1e-5 relative) in float32 and within the
    bfloat16 loss tolerance (gradient norm 2%) in bfloat16; every new
    parameter within ``STEP_ATOL`` of the reference's in float32. At step 1
    AdamW moves each weight by lr * sign(g) (lr = 6e-5 here), so in
    bfloat16, where a gradient near zero can round to the other sign in the
    other framework's backward pass (measured: 1 of 16,384 elements), a
    weight may differ by 2 * lr, plus one bfloat16 ulp of its magnitude
    (rtol 2**-7) from the cast."""
    jcfg, cfg = _cfgs("smollm_360m", dtype)
    jp, tp = _weights(jcfg, cfg)
    ocfg, jocfg = OptConfig(warmup_steps=10), JaxOptConfig(warmup_steps=10)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jocfg,
                                        grad_accum=accum))
    jp2, jopt2, jmet = jstep(jp, jax_init_opt_state(jp),
                             _jax_batch(data_batch))
    step = make_train_step(build_model(cfg, device="cpu"), ocfg,
                           grad_accum=accum)
    tp2, opt2, met = step(tp, init_opt_state(tp), _port_batch(data_batch))
    assert set(met) == set(jmet) == {"loss", "aux_loss", "grad_norm", "lr",
                                     "total_loss"}
    assert opt2["step"] == 1 and met["lr"] == float(jmet["lr"])
    want = from_jax_params(jax.tree.map(np.asarray, split_tree(jp2)[0]), cfg,
                           "cpu")
    if dtype == "float32":
        for k in ("loss", "total_loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
        for g, w in zip(leaves(tp2), leaves(want)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)
        masters = from_jax_params(jax.tree.map(np.asarray,
                                               jopt2["master"]), cfg, "cpu")
        for g, w in zip(leaves(opt2["master"]), leaves(masters)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=STEP_ATOL)
    else:
        assert abs(float(met["loss"]) - float(jmet["loss"])) < BF16_LOSS_ATOL
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=0.02)
        for g, w in zip(leaves(tp2), leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(_np(g), _np(w), rtol=2 ** -7,
                                       atol=2 * met["lr"])


def test_grad_accum_matches_one_batch(data_batch):
    """grad_accum 4 against 1 on the same batch (the reference test's
    bounds: loss within 5e-3, parameters within 5e-2), here in float32."""
    cfg = get_config("smollm_360m").reduced().replace(param_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tb = _port_batch(data_batch)
    outs = [make_train_step(model, OptConfig(), grad_accum=a)(
        params, init_opt_state(params), tb) for a in (1, 4)]
    assert abs(float(outs[0][2]["loss"]) - float(outs[1][2]["loss"])) < 5e-3
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert (a - b).abs().max() < 5e-2
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, OptConfig(), grad_accum=3)(
            params, init_opt_state(params), tb)


# ---------------------------------------------------------------------------
# checkpoint manager (mirrors tests/test_train.py)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(10, dtype=torch.bfloat16),
             "b": {"c": torch.ones((3, 3)), "l": [torch.zeros(2, 2)]},
             "n": 4, "step": np.asarray(7)}
    ops.reset_counters()
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert ops.counter("host_sync") == 3      # one counted sync per save
    assert mgr.all_steps() == [2, 3]          # gc keeps 2
    out = mgr.restore(3, state)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], state["a"])
    assert torch.equal(out["b"]["l"][0], state["b"]["l"][0])
    assert out["n"] == 4 and isinstance(out["n"], int)
    assert int(out["step"]) == 7 and isinstance(out["step"], np.ndarray)
    # a sub-tree restores that part alone
    assert torch.equal(mgr.restore(3, {"b": state["b"]})["b"]["c"],
                       state["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"a": torch.zeros(4)})


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.ones(5)}
    path = mgr.save(1, state)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(60)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="crc"):
        mgr.restore(1, state)


def test_checkpoint_tmp_dirs_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")  # crashed write
    mgr.save(1, {"a": torch.zeros(2)})
    assert mgr.latest_step() == 1


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    ops.reset_counters()
    mgr.save_async(5, {"a": torch.ones(100, 100)})
    assert ops.counter("host_sync") == 1      # taken before the writer starts
    mgr.wait()
    assert mgr.latest_step() == 5


# ---------------------------------------------------------------------------
# trainer: descent + preemption recovery (mirrors tests/test_train.py:161)
# ---------------------------------------------------------------------------
def test_training_loss_decreases_and_preemption_resume(tmp_path):
    cfg = get_config("smollm_360m").reduced()
    model = build_model(cfg, device="cpu")
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=48, global_batch=8,
                                            n_pool=2048, seed=0),
                                 device="cpu")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=100)
    fail = {"n": 0}

    def hook(step):
        if step == 25 and fail["n"] == 0:
            fail["n"] += 1
            raise SimulatedPreemption()

    tr = Trainer(model, pipe, opt, str(tmp_path / "a"), TrainerConfig(
        num_steps=35, ckpt_every=10, log_every=1), failure_hook=hook,
        device="cpu")
    tr.init_state()
    log = tr.run()
    assert fail["n"] == 1
    losses = {r["step"]: r["loss"] for r in log}
    assert losses[35] < losses[1], "loss must decrease"
    assert tr.ckpt.all_steps() == [10, 20, 30]

    ref = Trainer(model, pipe, opt, str(tmp_path / "b"), TrainerConfig(
        num_steps=35, ckpt_every=100, log_every=1), device="cpu")
    ref.init_state()
    ref_losses = {r["step"]: r["loss"] for r in ref.run()}
    # recovery replays the exact stream: final losses bit-identical
    assert losses[35] == ref_losses[35]
    assert all(torch.equal(a, b) for a, b in zip(leaves(tr.params),
                                                 leaves(ref.params)))


def test_trainer_refuses_a_model_on_another_device(tmp_path):
    cfg = get_config("smollm_360m").reduced()
    with pytest.raises(ValueError, match="model is on"):
        Trainer(build_model(cfg, device="cpu"), None, OptConfig(),
                str(tmp_path), device="meta")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_launch_train_then_serve_from_its_checkpoint(tmp_path, capsys):
    """launch.train --reduced --steps 3 --device cpu writes step 3; a second
    run resumes from it; launch.serve --ckpt-dir loads it and serves the
    trained parameters (its tokens equal a BatchServer's on them)."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "smollm_360m", "--reduced", "--device", "cpu",
            "--ckpt-dir", ck]
    tr = launch_train.run(base + ["--steps", "3", "--seq", "32",
                                  "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] arch=smollm-360m" in out and "admitted=" in out
    assert [r["step"] for r in tr.metrics_log] == [1, 2, 3]
    assert "[train] step=3 loss=" in out
    assert CheckpointManager(ck).latest_step() == 3
    assert launch_train.main(base + ["--steps", "4", "--seq", "32",
                                     "--ckpt-every", "4"]) == 0
    assert "[train] resumed at step 3" in capsys.readouterr().out

    done = launch_serve.run(["--arch", "smollm_360m", "--reduced", "--device",
                             "cpu", "--ckpt-dir", ck, "--requests", "4",
                             "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] loaded checkpoint step 4" in out
    from repro_torch.serve import BatchServer, admission_query
    cfg = get_config("smollm_360m").reduced()
    params = CheckpointManager(ck).restore(4, {"params": tr.params})["params"]
    want = BatchServer(build_model(cfg, device="cpu"), params, slots=4,
                       max_len=128, device="cpu").serve(
        launch_serve.requests(cfg, 4, 4, 0), admission_query())
    assert [r.rid for r in done] == [r.rid for r in want] and done
    for a, b in zip(done, want):
        np.testing.assert_array_equal(a.output, b.output)

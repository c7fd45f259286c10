"""The port's LM decode-serving path against the reference, on the CPU.

Qwen3-8B's reduced config (2 layers, d_model 128, 4 heads / 2 KV heads,
head_dim 32, qk-norm) with the reference's random weights carried across by
``models.convert.from_jax_params``; the same numpy tokens go through the
reference's jitted ``decode_step`` and the port's. Tolerances: float32 logits
atol 1e-4 (sums in another order); bfloat16 atol 0.0625, four bfloat16 ulps at
the logits' magnitude (2 to 4), because the two frameworks round to bfloat16
at other places (matmul outputs, silu, and the pruned branch's scores, which
the port's op takes in float32 from the bfloat16 inputs).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.params import split_tree
from repro.models.registry import build_model as jax_build_model
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro.serve import admission_query as jax_admission_query
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import vocab_padded
from repro_torch.serve import BatchServer, Request, admission_query
from repro_torch.serve.serve_step import greedy_sample

ATOL = {"float32": 1e-4, "bfloat16": 0.0625}
STEPS = 24
PRUNES = [
    {},
    dict(kv_block_prune=4, kv_block_size=16),
    dict(kv_block_prune=4, kv_block_size=16, kv_prune_groups=2),
    dict(kv_block_prune=2, kv_block_size=4),                 # drops blocks
    dict(kv_block_prune=3, kv_block_size=4, kv_prune_groups=2),
]


def _cfgs(dtype, **kw):
    return (jax_get_config("qwen3_8b").reduced().replace(param_dtype=dtype, **kw),
            get_config("qwen3_8b").reduced().replace(param_dtype=dtype, **kw))


@pytest.fixture(scope="module")
def weights():
    """{dtype: (reference params, port params)} of the reduced model."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype)
        jp = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
        tree = jax.tree.map(np.asarray, split_tree(jp)[0])
        out[dtype] = (jp, from_jax_params(tree, cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, STEPS)).astype(np.int32)


def _slots(kw):
    return 32 if kw.get("kv_block_size", 16) == 4 else 64


def _jax_decode(cfg, params, toks, slots):
    model = jax_build_model(cfg)
    b = toks.shape[0]
    cache = model.init_cache(b, slots, jnp.dtype(cfg.param_dtype))
    dec = jax.jit(model.decode_step)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]),
                        jnp.full((b,), t, jnp.int32))
        outs.append(np.asarray(lg, np.float32)[:, 0])
    return np.stack(outs, 1)


def _port_decode(cfg, params, toks, slots, visits=None):
    model = build_model(cfg, device="cpu")
    b = toks.shape[0]
    cache = model.init_cache(b, slots)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(
            params, cache, torch.as_tensor(toks[:, t:t + 1]),
            torch.full((b,), t, dtype=torch.int32), visits=visits)
        outs.append(lg.float().numpy()[:, 0])
    return np.stack(outs, 1), cache


@pytest.mark.parametrize("kw", PRUNES, ids=lambda kw: "-".join(
    f"{k.split('_')[-1]}{v}" for k, v in kw.items()) or "noprune")
def test_decode_step_matches_reference_f32(weights, tokens, kw):
    jcfg, cfg = _cfgs("float32", **kw)
    jp, tp = weights["float32"]
    want = _jax_decode(jcfg, jp, tokens, _slots(kw))
    ops.reset_counters()
    got, cache = _port_decode(cfg, tp, tokens, _slots(kw))
    assert got.shape == (2, STEPS, vocab_padded(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["float32"])
    pruned = STEPS * cfg.n_layers if kw else 0
    assert ops.counter("kv_visit_attention") == pruned
    np.testing.assert_array_equal(cache["pos"].numpy(), [STEPS, STEPS])


@pytest.mark.parametrize("kw", PRUNES[:2], ids=["noprune", "prune4"])
def test_decode_step_matches_reference_bf16(weights, tokens, kw):
    jcfg, cfg = _cfgs("bfloat16", **kw)
    jp, tp = weights["bfloat16"]
    want = _jax_decode(jcfg, jp, tokens, _slots(kw))
    got, _ = _port_decode(cfg, tp, tokens, _slots(kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["bfloat16"])


@pytest.mark.parametrize("groups", [0, 2])
def test_keepall_prune_equals_no_prune(weights, tokens, groups):
    """The reference's own knob test (test_perf_knobs.py), on the port."""
    _, cfg = _cfgs("bfloat16")
    tp = weights["bfloat16"][1]
    full, _ = _port_decode(cfg, tp, tokens, 48)
    pruned, _ = _port_decode(cfg.replace(kv_block_prune=4, kv_block_size=16,
                                         kv_prune_groups=groups),
                             tp, tokens, 64)
    np.testing.assert_allclose(full, pruned, rtol=0, atol=0.05)


def test_visit_lists_follow_the_prune(weights, tokens):
    """Every layer of every step lists keep' blocks, the block being written
    first (its bound is +inf), and blocks with no key yet only after every
    valid block."""
    _, cfg = _cfgs("float32", kv_block_prune=2, kv_block_size=4)
    visits = []
    _port_decode(cfg, weights["float32"][1], tokens, 32, visits=visits)
    assert len(visits) == STEPS * cfg.n_layers
    for i, (top, ub) in enumerate(visits):
        t = i // cfg.n_layers
        assert top.shape == (2, cfg.n_kv_heads, 2)
        assert (top[..., 0] == t // 4).all()
        n_valid = t // 4 + 1
        if n_valid >= 2:
            assert (top[..., 1] < n_valid).all()
        assert torch.isinf(ub).sum() > 0


def test_mha_decode_matches_reference_on_a_filled_cache():
    """One layer on a random cache and zone maps (bfloat16-free, float32):
    the output, the written slot and the updated zone maps agree."""
    from repro.models import layers as jax_layers
    from repro.models.params import Param
    jcfg, cfg = _cfgs("float32", kv_block_prune=3, kv_block_size=8)
    rng = np.random.default_rng(5)
    b, s, kv, hd, d = 2, 64, cfg.n_kv_heads, 32, cfg.d_model
    p = {"wq": rng.normal(size=(d, 4, hd)) * d ** -0.5,
         "wk": rng.normal(size=(d, kv, hd)) * d ** -0.5,
         "wv": rng.normal(size=(d, kv, hd)) * d ** -0.5,
         "wo": rng.normal(size=(4, hd, d)) * (4 * hd) ** -0.5,
         "q_norm": 1 + 0.1 * rng.normal(size=(hd,)),
         "k_norm": 1 + 0.1 * rng.normal(size=(hd,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    kmin = kc.reshape(b, 8, 8, kv, hd).min(2)
    kmax = kc.reshape(b, 8, 8, kv, hd).max(2)
    pos = np.array([37, 61], np.int32)
    y, k2, v2, ex = jax_layers.mha_decode(
        {k: Param(jnp.asarray(v), ()) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), jnp.asarray(kc), jnp.asarray(vc), jcfg,
        extras={"kmin": jnp.asarray(kmin), "kmax": jnp.asarray(kmax)})
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    tex = {"kmin": torch.as_tensor(kmin.copy()),
           "kmax": torch.as_tensor(kmax.copy())}
    visits = []
    got = layers.mha_decode({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x), torch.as_tensor(pos), tk, tv,
                            cfg, extras=tex, visits=visits)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(k2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v2), rtol=0, atol=1e-6)
    for name in ("kmin", "kmax"):
        np.testing.assert_allclose(tex[name].numpy(), np.asarray(ex[name]),
                                   rtol=0, atol=1e-6)
    assert visits[0][0].shape == (b, kv, 3)


def test_layers_match_reference():
    from repro.models import layers as jax_layers
    from repro.models.params import Param
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(32,))).astype(np.float32)
    positions = rng.integers(0, 30_000, size=(2, 3)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x)).numpy(),
        np.asarray(jax_layers.rmsnorm(jnp.asarray(scale), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.rope(torch.as_tensor(x), torch.as_tensor(positions), 1e6).numpy(),
        np.asarray(jax_layers.rope(jnp.asarray(x), jnp.asarray(positions), 1e6)),
        rtol=1e-4, atol=1e-4)
    w = {k: (rng.normal(size=sh) * 0.1).astype(np.float32) for k, sh in
         (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32)))}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        layers.mlp({k: torch.as_tensor(v) for k, v in w.items()},
                   torch.as_tensor(h)).numpy(),
        np.asarray(jax_layers.mlp({k: Param(jnp.asarray(v), ())
                                   for k, v in w.items()}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


def test_bf16_scores_knob_matches_reference(weights, tokens):
    """attn_scores_f32=False: the bfloat16 streaming softmax of _sdpa."""
    jcfg, cfg = _cfgs("bfloat16", attn_scores_f32=False)
    jp, tp = weights["bfloat16"]
    want = _jax_decode(jcfg, jp, tokens[:, :8], 16)
    got, _ = _port_decode(cfg, tp, tokens[:, :8], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["bfloat16"])


def test_init_shapes_match_reference_and_are_seeded():
    jcfg, cfg = _cfgs("bfloat16")
    jp = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: a.shape, split_tree(jp)[0])
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    c = model.init(torch.Generator().manual_seed(1))
    assert a["embed"]["table"].shape == shapes["embed"]["table"]
    assert a["embed"]["unembed"].shape == shapes["embed"]["unembed"]
    assert len(a["layers"]) == cfg.n_layers
    for name, sub in shapes["layers"].items():
        for lp in a["layers"]:
            if isinstance(sub, dict):
                for k, sh in sub.items():
                    assert lp[name][k].shape == sh[1:], (name, k)
            else:
                assert lp[name].shape == sub[1:], name
    assert a["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert a["layers"][0]["ln1"].dtype == torch.float32
    assert torch.equal(a["layers"][1]["mlp"]["wo"], b["layers"][1]["mlp"]["wo"])
    assert not torch.equal(a["layers"][1]["mlp"]["wo"],
                           c["layers"][1]["mlp"]["wo"])
    wq = a["layers"][0]["attn"]["wq"].float()
    assert wq.abs().max() <= 2 * cfg.d_model ** -0.5 * 1.01
    assert 0.8 < float(wq.std()) * cfg.d_model ** 0.5 < 0.95  # truncated std


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert ours.param_counts() == theirs.param_counts()


@pytest.mark.parametrize("arch,kw,match", [
    ("h2o_danube_1_8b", {"kv_block_prune": 4}, "4096-slot window"),
    ("recurrentgemma_2b", {"kv_block_prune": 4}, "2048-slot window"),
    ("seamless_m4t_large_v2", {"kv_block_prune": 4}, "encoder-decoder"),
    ("recurrentgemma_2b", {"kv_cache_int8": True}, "hybrid family"),
    ("seamless_m4t_large_v2", {"kv_cache_int8": True}, "audio family"),
])
def test_build_model_refuses_what_is_not_ported(arch, kw, match):
    """What is not ported because the reference itself cannot decode it: a
    block prune on a ring cache (it asserts), on the encoder-decoder (no
    zone maps), an int8 cache on the hybrid or the encoder-decoder (no
    scales)."""
    cfg = get_config(arch).replace(**kw)
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3_8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(model, {}, slots=1, max_len=8)
    from repro_torch.launch import train as launch_train
    from repro_torch.train import OptConfig, Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, None, OptConfig(), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3_8b", "--reduced", "--ckpt-dir",
                           str(tmp_path)])


def _requests(req_cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(2, 9))
                                        ).astype(np.int32),
                    max_new=int(rng.integers(2, 7)),
                    features=np.array([rng.random(), 8, 100.0, rng.random()],
                                      np.float32))
            for i in range(n)]


def test_batch_server_matches_reference(weights):
    """Same requests, same weights, a pruned cache whose slots are refilled
    (the stale zone maps of a refilled slot stay, as in the reference):
    the same admitted requests, in the same order, with the same tokens; one
    counted host sync per decode step."""
    kw = dict(kv_block_prune=2, kv_block_size=4)
    jcfg, cfg = _cfgs("float32", **kw)
    jp, tp = weights["float32"]
    jsrv = JaxBatchServer(jax_build_model(jcfg), jp, slots=2, max_len=32)
    want = jsrv.serve(_requests(JaxRequest, 8, cfg.vocab_size, 7),
                      jax_admission_query())
    srv = BatchServer(build_model(cfg, device="cpu"), tp, slots=2, max_len=32,
                      device="cpu")
    ops.reset_counters()
    got = srv.serve(_requests(Request, 8, cfg.vocab_size, 7), admission_query())
    assert 2 < len(want) < 8
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
    steps = ops.counter("host_sync") - 1           # minus the admission's
    assert steps == ops.counter("kv_visit_attention") // cfg.n_layers > 0


def test_admission_filter_matches_reference():
    reqs = _requests(Request, 40, 512, 8)
    got = BatchServer.admit(reqs, admission_query(0.5, 0.3), device="cpu")
    want = JaxBatchServer.admit(_requests(JaxRequest, 40, 512, 8),
                                jax_admission_query(0.5, 0.3))
    assert [r.rid for r in got] == [r.rid for r in want]


def test_greedy_sample_ties_go_to_the_first_index():
    logits = np.zeros((3, 1, 16), np.float32)
    logits[0, 0, [3, 7]] = 2.0
    logits[1, 0, [12, 15]] = 1.0      # 15 is padding: excluded
    logits[2, 0, :] = -1.0
    got = greedy_sample(torch.as_tensor(logits), 14)
    want = jnp.argmax(jnp.asarray(logits)[..., :14], axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3_8b", "--reduced", "--kv-prune", "2",
                       "--requests", "3", "--max-new", "2", "--max-len", "32",
                       "--device", "cpu"]) == 0
    assert "[serve] completed" in capsys.readouterr().out
    assert serve.main(["--arch", "qwen3_8b", "--reduced", "--kv-int8",
                       "--requests", "3", "--max-new", "2", "--max-len", "32",
                       "--device", "cpu"]) == 0
    assert "kv_int8=True kv_prune=0" in capsys.readouterr().out

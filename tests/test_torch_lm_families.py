"""Every LM family's decode-serving path in the port against the reference,
on the CPU.

Each of the ten architectures' reduced configs (a few layers, d_model 128,
head_dim 32) with the reference's random weights carried across by
``models.convert.from_jax_params``; the same numpy tokens (and, for the
encoder-decoder, the same numpy frame embeddings) go through the
reference's jitted ``decode_step`` and the port's. Tolerances: the ``ATOL``
of ``test_torch_lm.py`` — float32 logits 1e-4 (sums in another order),
bfloat16 0.0625 (four bfloat16 ulps at the logits' magnitude: the two
frameworks round to bfloat16 at other places). Exact: int8 codes and
scales of the same keys, MoE expert ids of the same router inputs, served
tokens (float32).

Two places where the same rounding noise crosses a discontinuity, stated
where they are tested: an int8 code (a key element within an ulp of a
rounding boundary can take the neighbouring code: ``INT8_ATOL``), and MoE
routing in bfloat16 (router inputs a bfloat16 ulp apart can swap a
near-tied k-th and (k+1)-th expert, which moves the layer's output by a
whole expert's share: the bfloat16 decode of the MoE families runs with a
zero router, every probability tied, so both sides route by the tie rule;
routing itself is held exactly in float32 and at the layer level in
bfloat16).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.params import split_tree
from repro.models.registry import build_model as jax_build_model
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro.serve import admission_query as jax_admission_query
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers, moe
from repro_torch.models.convert import from_jax_params
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model, shape_applicable
from repro_torch.models.transformer import vocab_padded
from repro_torch.serve import BatchServer, Request, admission_query

ATOL = {"float32": 1e-4, "bfloat16": 0.0625}
# float32 logits of an int8 decode: a code one step off moves a key element
# by its head's amax / 127; here that moves a logit by ~2e-3
INT8_ATOL = 1e-2
B, STEPS, SLOTS, ENC_LEN = 2, 12, 64, 16


def _cfgs(arch, dtype="float32", **kw):
    return (jax_get_config(arch).reduced().replace(param_dtype=dtype, **kw),
            get_config(arch).reduced().replace(param_dtype=dtype, **kw))


def _weights(jcfg, cfg, seed=1, zero_router=False):
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    if zero_router:
        from repro.models.params import Param
        r = jp["layers"]["moe"]["router"]
        jp["layers"]["moe"]["router"] = Param(jnp.zeros_like(r.value), r.axes)
    return jp, from_jax_params(jax.tree.map(np.asarray, split_tree(jp)[0]),
                               cfg, "cpu")


def _enc(cfg, seed=3, length=ENC_LEN):
    return np.random.default_rng(seed).normal(
        size=(B, length, cfg.d_model)).astype(np.float32)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


def _jax_decode(jcfg, jp, toks, slots=SLOTS):
    """The reference's teacher-forced logits (B, T, V) and its last cache."""
    model = jax_build_model(jcfg)
    cache = model.init_cache(B, slots, jnp.dtype(jcfg.param_dtype))
    if jcfg.encoder_layers:
        cache = model.fill_cross_cache(jp, cache, jnp.asarray(_enc(jcfg)))
    dec = jax.jit(model.decode_step)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = dec(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                        jnp.full((B,), t, jnp.int32))
        outs.append(np.asarray(lg, np.float32)[:, 0])
    return np.stack(outs, 1), cache


def _port_decode(cfg, tp, toks, slots=SLOTS):
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(B, slots)
    if cfg.encoder_layers:
        model.fill_cross_cache(tp, cache, torch.as_tensor(_enc(cfg)))
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(tp, cache,
                                      torch.as_tensor(toks[:, t:t + 1]),
                                      torch.full((B,), t, dtype=torch.int32))
        outs.append(lg.float().numpy()[:, 0])
    return np.stack(outs, 1), cache


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference(arch, dtype):
    """Teacher-forced decode of every family (the encoder-decoder after
    ``fill_cross_cache``): logits within ATOL at every step. (bfloat16 MoE:
    the zero router of the module docstring.)"""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, cfg, zero_router=(cfg.family == "moe"
                                              and dtype == "bfloat16"))
    toks = _tokens(STEPS)
    want, _ = _jax_decode(jcfg, jp, toks)
    got, cache = _port_decode(cfg, tp, toks)
    assert got.shape == (B, STEPS, vocab_padded(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])
    np.testing.assert_array_equal(cache["pos"].numpy(), [STEPS] * B)


def _flat_cache(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat_cache(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,kw", [
    ("qwen3_8b", {}),
    ("qwen3_8b", dict(kv_block_prune=2, kv_block_size=16)),
    ("deepseek_moe_16b", dict(kv_block_prune=2, kv_block_size=16)),
    ("h2o_danube_1_8b", {}),
], ids=["qwen3", "qwen3-prune2", "deepseek-prune2", "h2o-ring"])
def test_int8_decode_matches_reference(arch, kw):
    """int8 KV caches, float32, with and without the prune, 40 steps: logits
    within INT8_ATOL; the codes the decode leaves in the cache within one
    step of the reference's (at most 0.1% off: the keys differ by float32
    ulps, see ``test_int8_write_is_bit_identical`` for equal keys), the
    scales within 1e-3 relative; one counted kv_visit_attention per layer
    and step under the prune."""
    jcfg, cfg = _cfgs(arch, kv_cache_int8=True, **kw)
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(40)
    want, jcache = _jax_decode(jcfg, jp, toks)
    ops.reset_counters()
    got, cache = _port_decode(cfg, tp, toks)
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL)
    assert cache["k"].dtype == torch.int8
    for name in ("k", "v"):
        d = cache[name].numpy().astype(np.int32) - np.asarray(jcache[name])
        assert np.abs(d).max() <= 1 and (d != 0).mean() <= 1e-3, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-3,
                                   atol=0, err_msg=name)
    pruned = 40 * cfg.n_layers if kw else 0
    assert ops.counter("kv_visit_attention") == pruned


@pytest.mark.parametrize("arch,kw", [
    ("deepseek_moe_16b", {}),
    ("deepseek_moe_16b", dict(kv_block_prune=2, kv_block_size=8)),
    ("h2o_danube_1_8b", {})], ids=["full", "prune2", "ring"])
def test_int8_write_is_bit_identical(arch, kw):
    """One layer's int8 write on inputs whose keys both packages compute
    exactly (dyadic x and weights, position 0: RoPE is the identity): the
    codes and scales written equal the reference's bit for bit; the output
    over a random int8 cache agrees within 1e-5."""
    from repro.models import layers as jax_layers
    from repro.models.params import Param
    jcfg, cfg = _cfgs(arch, kv_cache_int8=True, **kw)
    rng = np.random.default_rng(11)
    s, kv, hd, d = 32, cfg.n_kv_heads, 32, cfg.d_model
    p = {"wq": rng.integers(-8, 9, (d, 4, hd)) / 64,
         "wk": rng.integers(-8, 9, (d, kv, hd)) / 64,
         "wv": rng.integers(-8, 9, (d, kv, hd)) / 64,
         "wo": rng.normal(size=(4, hd, d)) * (4 * hd) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.integers(-8, 9, (B, 1, d)) / 4).astype(np.float32)
    kc = rng.integers(-127, 128, (B, s, kv, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, s, kv, hd)).astype(np.int8)
    ex = {"k_scale": rng.random((B, s, kv, 1)).astype(np.float32) / 50,
          "v_scale": rng.random((B, s, kv, 1)).astype(np.float32) / 50}
    if kw:
        big = np.float32(3e38)
        ex["kmin"] = np.full((B, s // 8, kv, hd), big, np.float32)
        ex["kmax"] = np.full((B, s // 8, kv, hd), -big, np.float32)
    window = cfg.sliding_window
    pos = np.zeros((B,), np.int32)
    y, k2, v2, ex2 = jax_layers.mha_decode(
        {k: Param(jnp.asarray(v), ()) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), jnp.asarray(kc), jnp.asarray(vc), jcfg,
        window=window, extras={k: jnp.asarray(v) for k, v in ex.items()})
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    tex = {k: torch.as_tensor(v.copy()) for k, v in ex.items()}
    got = layers.mha_decode({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x), torch.as_tensor(pos), tk, tv,
                            cfg, window=window, extras=tex)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tex[name].numpy(), np.asarray(ex2[name]))
    assert (tk.numpy() != kc).any()              # the write happened
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_identical(dtype):
    """Codes and scales of random keys and of values that land exactly on
    a rounding tie (x / scale = k + 0.5): round half to even, as jnp.round."""
    from repro.models import layers as jax_layers
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, 4, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # the 1e-12 floor
    x[1, 0, 1, :] = np.arange(32) - 15.5             # ties at +-0.5 steps
    x[1, 0, 1, 0] = 127.0                            # amax: scale 1.0
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    q, s = layers.quantize_kv(tx)
    jq, js = jax_layers.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1, 0, 1, 1].item() == -14      # -14.5 rounds to even


@pytest.mark.parametrize("arch,window,steps", [
    ("h2o_danube_1_8b", 64, 140), ("recurrentgemma_2b", 32, 70)])
def test_ring_cache_past_twice_the_window(arch, window, steps):
    """Sliding-window (64 slots) and local (32 slots) ring caches decoded
    past twice their window: float32 logits within ATOL at every step."""
    jcfg, cfg = _cfgs(arch)
    assert (cfg.sliding_window or cfg.local_window) == window
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(steps, seed=5)
    want, _ = _jax_decode(jcfg, jp, toks, slots=128)
    got, cache = _port_decode(cfg, tp, toks, slots=128)
    kv = cache["k"] if "k" in cache else cache["groups"]["k"]
    assert kv.shape[2] == window
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["float32"])


def test_ring_key_positions_match_reference():
    from repro.models import layers as jax_layers
    pos = np.array([0, 5, 63, 64, 65, 200], np.int32)
    for n_slots, window in ((64, 64), (32, 64), (128, None)):
        got = layers.decode_key_positions(torch.as_tensor(pos), n_slots, window)
        want = jax_layers.decode_key_positions(jnp.asarray(pos), n_slots,
                                               window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_moe_16b"])
def test_moe_routing_and_output_match_reference(arch):
    """At S = 16 tokens a row (capacity 5 of 8 experts at top-2: tokens
    drop): the expert ids equal the reference's exactly, the output and aux
    loss agree in float32."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = tp["layers"][0]["moe"]
    x = np.random.default_rng(6).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    jlog = jnp.einsum("bsd,de->bse", jnp.asarray(x), jl["router"].value)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jlog, axis=-1), cfg.moe.top_k)
    _, _, idx = moe.route(tl, torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jy, jaux = jax_moe.moe_apply(jl, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tl, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_moe_16b"])
def test_moe_layer_matches_reference_bf16(arch):
    """bfloat16 weights and the same bfloat16 inputs (S = 16, tokens
    drop): the expert ids equal the reference's exactly, the output within
    one bfloat16 ulp of its magnitude (|y| < 32: 0.125)."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jp, tp = _weights(jcfg, cfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = tp["layers"][0]["moe"]
    x = np.random.default_rng(6).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    jlog = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32), jl["router"].value)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jlog, axis=-1), cfg.moe.top_k)
    np.testing.assert_array_equal(moe.route(tl, tx, cfg)[2].numpy(),
                                  np.asarray(jidx))
    jy, _ = jax_moe.moe_apply(jl, jx, jcfg)
    y, _ = moe.moe_apply(tl, tx, cfg)
    assert np.abs(np.asarray(jy, np.float32)).max() < 32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=0, atol=0.125)


def test_moe_ties_go_to_the_lower_expert():
    """A router with repeated columns gives exactly tied probabilities:
    ``jax.lax.top_k`` picks the lower expert id, and so must the port."""
    _, cfg = _cfgs("arctic_480b")
    rng = np.random.default_rng(7)
    router = rng.normal(size=(cfg.d_model, 4)).astype(np.float32)
    router = np.concatenate([router, router], axis=1)      # experts e, e + 4
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    _, _, idx = moe.route({"router": torch.as_tensor(router)},
                          torch.as_tensor(x), cfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                      jnp.asarray(router)), axis=-1)
    _, jidx = jax.lax.top_k(probs, cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[..., 1] == idx[..., 0] + 4).all()          # the tie's pair


def test_hybrid_with_a_tail_matches_reference():
    """recurrentgemma at 5 layers: one (rec, rec, attn) group and a tail of
    two recurrent layers."""
    jcfg, cfg = _cfgs("recurrentgemma_2b", n_layers=5)
    jp, tp = _weights(jcfg, cfg)
    assert len(tp["groups"]) == 1 and len(tp["tail"]) == 2
    toks = _tokens(STEPS)
    want, jcache = _jax_decode(jcfg, jp, toks)
    got, cache = _port_decode(cfg, tp, toks)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["float32"])
    for name, t in _flat_cache({"groups": cache["groups"],
                                "tail": cache["tail"]}).items():
        a = jcache
        for part in name.split("."):
            a = a[part]
        np.testing.assert_allclose(_np(t), np.asarray(a, np.float32), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_ssm_state_matches_reference():
    """mamba2 float32: the recurrent and conv states after the decode."""
    jcfg, cfg = _cfgs("mamba2_780m")
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(STEPS)
    _, jcache = _jax_decode(jcfg, jp, toks)
    _, cache = _port_decode(cfg, tp, toks)
    for name, t in cache["layers"].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache["layers"][name]),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_encoder_and_cross_cache_match_reference():
    """``encode`` and ``fill_cross_cache`` (the encoder's bidirectional
    self-attention over stub frame embeddings, then each decoder layer's
    cross K/V), float32."""
    jcfg, cfg = _cfgs("seamless_m4t_large_v2")
    jp, tp = _weights(jcfg, cfg)
    jmodel = jax_build_model(jcfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, EncDecLM)
    enc = _enc(cfg, length=24)
    np.testing.assert_allclose(
        model.encode(tp, torch.as_tensor(enc)).numpy(),
        np.asarray(jmodel.encode(jp, jnp.asarray(enc))), rtol=0, atol=1e-4)
    jc = jmodel.fill_cross_cache(jp, jmodel.init_cache(B, 32, jnp.float32),
                                 jnp.asarray(enc))
    cache = model.fill_cross_cache(tp, model.init_cache(B, 32),
                                   torch.as_tensor(enc))
    for name in ("xk", "xv"):
        assert cache[name].shape == jc[name].shape == (cfg.n_layers, B, 24,
                                                       cfg.n_kv_heads, 32)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   rtol=0, atol=1e-4)


def test_chunked_self_attention_matches_reference():
    """``mha_train`` past one query chunk (q_chunk 8 of 24), causal with a
    window and bidirectional."""
    from repro.models import layers as jax_layers
    jcfg, cfg = _cfgs("h2o_danube_1_8b", q_chunk=8)
    jp, tp = _weights(jcfg, cfg)
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = tp["layers"][0]["attn"]
    x = np.random.default_rng(8).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    for kw in (dict(causal=True, window=5), dict(causal=False)):
        got = layers.mha_train(ta, torch.as_tensor(x), torch.as_tensor(pos),
                               cfg, **kw)
        want = jax_layers.mha_train(ja, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                    **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def _requests(req_cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(2, 9))
                                        ).astype(np.int32),
                    max_new=int(rng.integers(2, 7)),
                    features=np.array([0.5, 8, 100.0, 0.5], np.float32))
            for i in range(n)]


# one config per family; the dense one with int8, the hybrid's ring and
# refilled slots, the encoder-decoder with its cross cache filled
SERVED = [("h2o_danube_1_8b", dict(kv_cache_int8=True)),
          ("deepseek_moe_16b", dict(kv_block_prune=2, kv_block_size=4,
                                    kv_cache_int8=True)),
          ("mamba2_780m", {}), ("recurrentgemma_2b", {}),
          ("llava_next_34b", dict(kv_block_prune=2, kv_block_size=4)),
          ("seamless_m4t_large_v2", {})]


@pytest.mark.parametrize("arch,kw", SERVED, ids=[a for a, _ in SERVED])
def test_batch_server_matches_reference(arch, kw):
    """8 requests on 2 slots (refilled slots keep their state, as the
    reference's): the same requests in the same order with the same tokens,
    float32; one counted host sync per decode step, for every family."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _weights(jcfg, cfg)
    jmodel = jax_build_model(jcfg)
    jsrv = JaxBatchServer(jmodel, jp, slots=2, max_len=32)
    model = build_model(cfg, device="cpu")
    srv = BatchServer(model, tp, slots=2, max_len=32, device="cpu")
    if cfg.encoder_layers:
        enc = _enc(cfg, length=8)
        jsrv.cache = jmodel.fill_cross_cache(jp, jsrv.cache, jnp.asarray(enc))
        model.fill_cross_cache(tp, srv.cache, torch.as_tensor(enc))
    want = jsrv.serve(_requests(JaxRequest, 8, cfg.vocab_size, 7),
                      jax_admission_query())
    steps = []
    step = srv.step_fn
    srv.step_fn = lambda *a: steps.append(1) or step(*a)
    ops.reset_counters()
    got = srv.serve(_requests(Request, 8, cfg.vocab_size, 7), admission_query())
    assert len(want) == 8
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
    assert ops.counter("host_sync") - 1 == len(steps) > 0   # + the admission


def test_refilled_slot_keeps_the_recurrent_state():
    """The reference's refill quirk on an SSM (float32, one slot): the
    second request starts from the first one's recurrent state and conv
    window. The port's state after serving both equals the reference's,
    and differs from the state after serving the second request alone."""
    jcfg, cfg = _cfgs("mamba2_780m")
    jp, tp = _weights(jcfg, cfg)
    jsrv = JaxBatchServer(jax_build_model(jcfg), jp, slots=1, max_len=32)
    jsrv.serve(_requests(JaxRequest, 2, cfg.vocab_size, 9),
               jax_admission_query())

    def served(reqs):
        srv = BatchServer(build_model(cfg, device="cpu"), tp, slots=1,
                          max_len=32, device="cpu")
        srv.serve(reqs, admission_query())
        return srv.cache["layers"]
    both = served(_requests(Request, 2, cfg.vocab_size, 9))
    alone = served(_requests(Request, 2, cfg.vocab_size, 9)[1:])
    for name, t in both.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jsrv.cache["layers"][name]),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.allclose(t, alone[name], rtol=0, atol=1e-3), name


def test_every_config_builds_and_decodes_or_refuses_as_the_reference():
    """All ten reduced configs build and decode on the CPU, also with an
    int8 cache wherever the reference takes one; the refusals are exactly
    the configurations the reference cannot run."""
    refused = set()
    for arch in ARCH_IDS:
        for kw in ({}, dict(kv_cache_int8=True),
                   dict(kv_block_prune=2, kv_block_size=16)):
            cfg = get_config(arch).reduced().replace(**kw)
            try:
                model = build_model(cfg, device="cpu")
            except NotImplementedError:
                refused.add((arch, tuple(kw)))
                continue
            params = model.init(torch.Generator().manual_seed(0))
            cache = model.init_cache(B, 32)
            lg, _ = model.decode_step(params, cache,
                                      torch.ones((B, 1), dtype=torch.int32),
                                      torch.zeros((B,), dtype=torch.int32))
            assert torch.isfinite(lg).all(), (arch, kw)
    prune = ("kv_block_prune", "kv_block_size")
    assert refused == {
        ("h2o_danube_1_8b", prune), ("recurrentgemma_2b", prune),
        ("seamless_m4t_large_v2", prune),
        ("recurrentgemma_2b", ("kv_cache_int8",)),
        ("seamless_m4t_large_v2", ("kv_cache_int8",))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_matches_reference(arch):
    from repro.configs import SHAPES
    from repro.models.registry import shape_applicable as jax_applicable
    for shape in SHAPES:
        assert shape_applicable(get_config(arch), shape) == \
            jax_applicable(jax_get_config(arch), shape)


def test_serve_launcher_int8_prune_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "deepseek_moe_16b", "--reduced", "--kv-int8",
                       "--kv-prune", "2", "--requests", "3", "--max-new", "2",
                       "--max-len", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] completed" in out and "kv_int8=True" in out

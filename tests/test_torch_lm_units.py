"""The LM stack's pieces in the port against the reference's on the same
inputs, on the CPU: the norm, RoPE, the MLP under each activation, the
softcap, the causal mask, ``_sdpa`` with GQA (softcap, windows), the
embedding and the head; ``_streaming_sdpa`` against the dense path on the
cases of ``tests/test_streaming_attention.py`` (the local band included);
the SSD scan, the conv, the decode recurrence; MoE routing with generous
capacity, with token drops and with tied router probabilities.

Tolerances: a single op or layer at rtol 1e-4, atol 1e-5 (f32 rounding of
sums in another order); a whole stack's logits as ``tests/_torch_lm.py``
says; the streaming forward against the dense one at
``test_streaming_attention.py``'s rtol 2e-2, atol 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as Rmoe
from repro.models import ssm as Rssm
from repro.models.config import ModelConfig as RefConfig

from _torch_lm import assert_close, np_tree
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import moe as Pmoe
from repro_torch.models import ssm as Pssm
from repro_torch.models.config import ModelConfig

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=96, vocab_size=128, head_dim=16, dtype="float32")
    base.update(kw)
    return RefConfig(**base), ModelConfig(**base)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm():
    g = _rng(1)
    x = (g.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    scale = g.standard_normal(64).astype(np.float32) * 0.1
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    _close(PL.rmsnorm(PL.RMSNorm(_t(scale)), _t(x), 1e-6), want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    g = _rng(2)
    x = g.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    _close(PL.rope_frequencies(32, theta), RL.rope_frequencies(32, theta))
    _close(PL.apply_rope(_t(x), _t(pos), theta), RL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                                               theta))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_under_each_activation(act, dtype):
    """bf16: the activations round after each op as the reference's do,
    so the MLP agrees bit for bit on the same weights."""
    rcfg, pcfg = _cfgs(act=act, dtype=dtype)
    params = RL.init_mlp(jax.random.PRNGKey(3), rcfg)
    x = jnp.asarray(_rng(3).standard_normal((2, 7, 64)) * 2, jnp.dtype(dtype))
    mlp = PL.MLP(*(convert._lm_tensor(np.asarray(params[k]), "cpu")
                   for k in ("w_gate", "w_up", "w_down")))
    got = PL.apply_mlp(mlp, convert._lm_tensor(np.asarray(x), "cpu"), pcfg)
    want = RL.apply_mlp(params, x, rcfg)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    else:
        _close(got, want)


def test_softcap_and_capped_logits():
    g = _rng(4)
    x = (g.standard_normal((4, 50)) * 80).astype(np.float32)
    _close(PL.softcap(_t(x), 30.0), RL.softcap(jnp.asarray(x), 30.0))
    rcfg, pcfg = _cfgs(logit_softcap=30.0, tie_embeddings=True)
    tok = g.standard_normal((128, 64)).astype(np.float32)
    h = g.standard_normal((2, 3, 64)).astype(np.float32) * 5
    want = RL.lm_logits({}, {"tok": jnp.asarray(tok)}, jnp.asarray(h), rcfg)
    got = PL.lm_logits(PL.LMHead(), PL.Embedding(_t(tok)), _t(h), pcfg)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_tied_scale_and_head(dtype):
    """The tied table's sqrt(d) rounded to the activation dtype first; the
    head's f32 output from bf16 operands."""
    rcfg, pcfg = _cfgs(tie_embeddings=True, dtype=dtype, d_model=72)  # sqrt(72) rounds
    params = RL.init_embedding(jax.random.PRNGKey(5), rcfg)
    tokens = np.array([[1, 5, 127], [0, 64, 3]], np.int32)
    emb = PL.Embedding(convert._lm_tensor(np.asarray(params["tok"]), "cpu"))
    x = RL.embed_tokens(params, jnp.asarray(tokens), rcfg)
    got = PL.embed_tokens(emb, _t(tokens), pcfg)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(x, np.float32))
    _close(PL.lm_logits(PL.LMHead(), emb, got, pcfg), RL.lm_logits({}, params, x, rcfg))


@pytest.mark.parametrize("window,offset", [(0, 0), (3, 0), (0, 5), (4, 7)])
def test_causal_mask(window, offset):
    np.testing.assert_array_equal(PA.causal_mask(6, 13, window, offset).numpy(),
                                  np.asarray(RA.causal_mask(6, 13, window, offset)))


@pytest.mark.parametrize("heads,kv,softcap,window", [(4, 4, None, 0), (8, 2, None, 0),
                                                     (8, 2, 50.0, 5), (6, 1, None, 0)])
def test_sdpa_with_gqa(heads, kv, softcap, window):
    """Head h reads KV head h // (H // KV), as ``jnp.repeat`` gives it."""
    rcfg, pcfg = _cfgs(n_heads=heads, n_kv_heads=kv, attn_softcap=softcap)
    g = _rng(6)
    q = g.standard_normal((2, 11, heads, 16)).astype(np.float32) * 2
    k = g.standard_normal((2, 11, kv, 16)).astype(np.float32) * 2
    v = g.standard_normal((2, 11, kv, 16)).astype(np.float32)
    mask = np.asarray(RA.causal_mask(11, 11, window))
    want = RA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), rcfg)
    _close(PA._sdpa(_t(q), _t(k), _t(v), _t(mask), pcfg), want)
    want = RA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, rcfg)
    _close(PA._sdpa(_t(q), _t(k), _t(v), None, pcfg), want)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("is_local", [False, True])
def test_decode_attend(ragged, is_local):
    """One token appended at each row's length (rows at different lengths
    when ragged), then attention over the prefix (a window on local
    layers); a row at the cache's end writes nothing, as the reference's
    one-hot of an out-of-range length."""
    rcfg, pcfg = _cfgs(sliding_window=4, ragged_decode=ragged, qkv_bias=True)
    params = jax.jit(RA.init_attention, static_argnums=1)(jax.random.PRNGKey(8), rcfg)
    params = dict(params, bq=params["bq"] + 0.1, bk=params["bk"] - 0.2, bv=params["bv"] + 0.3)
    g = _rng(8)
    x = g.standard_normal((3, 1, 64)).astype(np.float32)
    k = g.standard_normal((3, 10, 2, 16)).astype(np.float32)
    v = g.standard_normal((3, 10, 2, 16)).astype(np.float32)
    lens = np.array([6, 3, 10] if ragged else [6, 6, 6], np.int32)
    k[np.arange(10)[None, :] >= lens[:, None]] = 0.0
    v[np.arange(10)[None, :] >= lens[:, None]] = 0.0
    out, kv = jax.jit(RA.decode_attend, static_argnums=4, static_argnames="is_local")(
        params, jnp.asarray(x), RA.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(lens), rcfg,
        is_local=is_local)
    attn = PA.Attention(*(_t(params[n]) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")))
    cache = PA.KVCache(_t(k), _t(v))
    got, got_kv = PA.decode_attend(attn, _t(x), cache, _t(lens), pcfg, is_local=is_local)
    _close(got, out)
    _close(got_kv.k, kv.k)
    _close(got_kv.v, kv.v)
    assert got_kv.k is cache.k  # updated in place


# ---------------------------------------------------------------------------
# streaming attention
# ---------------------------------------------------------------------------


def _stream_pair(arch, seed, shape):
    base = ref_get_config(arch)
    over = dict(ssm_chunk=16, sliding_window=32 if base.sliding_window else 0)
    rcfg, pcfg = base.reduced(**over), get_config(arch).reduced(**over)
    stream = dict(streaming_attn_threshold=64, streaming_chunk=32)
    params = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(seed), rcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 1), shape, 0, rcfg.vocab_size)
    return rcfg, pcfg, stream, params, tokens


@pytest.mark.parametrize("arch,seed,shape", [("qwen2_72b", 0, (2, 128)),
                                             ("hymba_1_5b", 0, (2, 128)),
                                             ("gemma2_9b", 0, (2, 128)),
                                             ("deepseek_7b", 0, (2, 128)),
                                             ("hymba_1_5b", 2, (1, 96))])
def test_streaming_equals_dense_and_the_reference(arch, seed, shape):
    """The port's streaming forward against its dense forward
    (``test_streaming_attention.py``'s tolerance) and against the
    reference's streaming forward; the last case is the local band at
    window == chunk (chunk 0 visited twice at qi = 0)."""
    rcfg, pcfg, stream, params, tokens = _stream_pair(arch, seed, shape)
    model = convert.lm_params_from_reference(np_tree(params), pcfg, "cpu")
    batch = {"tokens": _t(tokens)}
    dense = PM.forward(model, batch, pcfg)
    streamed = PM.forward(model, batch, dataclasses.replace(pcfg, **stream))
    np.testing.assert_allclose(streamed.numpy(), dense.numpy(), rtol=2e-2, atol=2e-4)
    want = jax.jit(RM.forward, static_argnums=2)(params, {"tokens": tokens},
                                                 dataclasses.replace(rcfg, **stream))
    assert_close(streamed, want)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def test_segsum_and_causal_conv():
    g = _rng(9)
    x = -np.abs(g.standard_normal((2, 3, 8))).astype(np.float32)
    got, want = Pssm._segsum(_t(x)).numpy(), np.asarray(Rssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], rtol=RTOL,
                               atol=ATOL)
    xbc = g.standard_normal((2, 7, 12)).astype(np.float32)
    w = g.standard_normal((4, 12)).astype(np.float32)
    b = g.standard_normal(12).astype(np.float32)
    _close(Pssm._causal_conv(_t(xbc), _t(w), _t(b)),
           Rssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan(with_state):
    g = _rng(10)
    Bsz, S, H, P, N = 2, 24, 3, 4, 5
    x = g.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dA = -np.abs(g.standard_normal((Bsz, S, H))).astype(np.float32) * 0.3
    Bm = g.standard_normal((Bsz, S, N)).astype(np.float32)
    Cm = g.standard_normal((Bsz, S, N)).astype(np.float32)
    s0 = g.standard_normal((Bsz, H, P, N)).astype(np.float32) if with_state else None
    y, st = jax.jit(Rssm.ssd_scan, static_argnums=4)(jnp.asarray(x), jnp.asarray(dA), jnp.asarray(Bm), jnp.asarray(Cm), 8,
                          None if s0 is None else jnp.asarray(s0))
    py, pst = Pssm.ssd_scan(_t(x), _t(dA), _t(Bm), _t(Cm), 8, None if s0 is None else _t(s0))
    _close(py, y)
    _close(pst, st)
    assert pst.dtype == torch.float32


@pytest.mark.parametrize("S", [24, 21])
def test_apply_ssm_with_state_and_decode(S):
    """The chunked path (a ragged S pads to the chunk, the identity) and
    the recurrent step from a cache."""
    rcfg = ref_get_config("mamba2_130m").reduced(ssm_chunk=8)
    pcfg = get_config("mamba2_130m").reduced(ssm_chunk=8)
    params = jax.jit(Rssm.init_ssm, static_argnums=1)(jax.random.PRNGKey(11), rcfg)
    p = np_tree(params)
    ssm = Pssm.SSM(*(_t(p[k]) for k in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")),
                   PL.RMSNorm(_t(p["norm"]["scale"])), _t(p["out_proj"]))
    g = _rng(11)
    x = g.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    y, st = jax.jit(Rssm.apply_ssm_with_state, static_argnums=2)(params, jnp.asarray(x), rcfg)
    py, pst = Pssm.apply_ssm_with_state(ssm, _t(x), pcfg)
    _close(py, y)
    _close(pst, st)
    conv = g.standard_normal((2, 3, Rssm.conv_dim(rcfg))).astype(np.float32)
    state = g.standard_normal((2, rcfg.ssm_heads, rcfg.ssm_head_dim,
                               rcfg.ssm_state)).astype(np.float32)
    out, cache = jax.jit(Rssm.decode_ssm, static_argnums=3)(
        params, jnp.asarray(x[:, :1]), Rssm.SSMCache(jnp.asarray(conv), jnp.asarray(state)), rcfg)
    pout, pcache = Pssm.decode_ssm(ssm, _t(x[:, :1]), Pssm.SSMCache(_t(conv), _t(state)), pcfg)
    _close(pout, out)
    _close(pcache.conv, cache.conv)
    _close(pcache.state, cache.state)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_pair(rcfg, pcfg, seed):
    params = jax.jit(Rmoe.init_moe, static_argnums=1)(jax.random.PRNGKey(seed), rcfg)
    p = np_tree(params)

    def mlp(d):
        return PL.MLP(_t(d["w_gate"]), _t(d["w_up"]), _t(d["w_down"]))

    moe = Pmoe.MoE(_t(p["router"]), _t(p["w_gate"]), _t(p["w_up"]), _t(p["w_down"]),
                   mlp(p["shared"]) if "shared" in p else None,
                   mlp(p["dense"]) if "dense" in p else None)
    return params, moe


def _ref_moe(params, x, rcfg):
    return jax.jit(Rmoe.apply_moe, static_argnums=2)(params, x, rcfg)


def _ref_drops(params, x, rcfg):
    """How many of the reference's assignments fall past capacity."""
    logits = x.astype(jnp.float32) @ params["router"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), rcfg.experts_per_token)
    C = Rmoe._capacity(x.shape[1], rcfg)
    counts = np.stack([np.bincount(np.asarray(i).reshape(-1), minlength=rcfg.n_experts)
                       for i in idx])
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("case", ["generous", "drops", "shared_dense", "decode"])
def test_apply_moe(case):
    """Generous capacity (nothing dropped); arctic ``reduced(capacity_factor
    =0.5)`` at S = 24, where C = 4 against ~6 assignments an expert, so the
    reference drops tokens; kimi-style shared experts with arctic's dense
    residual; one token a row (decode)."""
    if case == "drops":
        rcfg = ref_get_config("arctic_480b").reduced(capacity_factor=0.5)
        pcfg = get_config("arctic_480b").reduced(capacity_factor=0.5)
        shape = (2, 24, rcfg.d_model)
    else:
        kw = dict(family="moe", n_experts=8, experts_per_token=2, moe_d_ff=48, min_capacity=4)
        if case == "generous":
            kw.update(capacity_factor=8.0, min_capacity=64)
        if case == "shared_dense":
            kw.update(n_shared_experts=1, moe_dense_residual=True)
        rcfg, pcfg = _cfgs(**kw)
        shape = (16, 1, 64) if case == "decode" else (2, 16, 64)
    params, moe = _moe_pair(rcfg, pcfg, 12)
    x = jnp.asarray(_rng(12).standard_normal(shape).astype(np.float32))
    drops = _ref_drops(params, x, rcfg)
    if case in ("generous", "decode"):
        assert drops == 0, drops
    if case == "drops":
        assert drops > 0
    _close(Pmoe.apply_moe(moe, _t(x), pcfg), _ref_moe(params, x, rcfg))


def test_moe_routes_ties_as_top_k():
    """Tied router probabilities (duplicated router columns, and an all-zero
    token whose probabilities all tie) route as ``lax.top_k`` routes them,
    the lower expert first, with drops at a capacity of 1."""
    rcfg, pcfg = _cfgs(family="moe", n_experts=8, experts_per_token=2, moe_d_ff=48,
                       capacity_factor=0.25, min_capacity=1)
    params, _ = _moe_pair(rcfg, pcfg, 13)
    router = np.asarray(params["router"]).copy()
    router[:, 5] = router[:, 1]
    router[:, 6] = router[:, 2]
    router[:, 7] = router[:, 2]
    params = dict(params, router=jnp.asarray(router))
    _, moe = _moe_pair(rcfg, pcfg, 13)
    moe.router.data = _t(router)
    x = _rng(13).standard_normal((2, 12, 64)).astype(np.float32)
    x[0, 3] = 0.0
    x = jnp.asarray(x)
    want_idx = jax.lax.top_k(jax.nn.softmax(x @ params["router"], -1), 2)[1]
    _, got_idx, _ = Pmoe._route(moe, _t(x), pcfg)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert np.asarray(want_idx)[0, 3].tolist() == [0, 1]
    assert _ref_drops(params, x, rcfg) > 0
    _close(Pmoe.apply_moe(moe, _t(x), pcfg), _ref_moe(params, x, rcfg))


def test_load_balance_loss():
    rcfg, pcfg = _cfgs(family="moe", n_experts=8, experts_per_token=2, moe_d_ff=48)
    g = _rng(14)
    logits = g.standard_normal((2, 9, 8)).astype(np.float32)
    idx = g.integers(0, 8, (2, 9, 2)).astype(np.int32)
    _close(Pmoe.load_balance_loss(_t(logits), _t(idx), pcfg),
           Rmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), rcfg))


def test_local_layer_flags():
    for arch in ("gemma2_9b", "hymba_1_5b", "deepseek_7b"):
        for n in (1, 2, 32):
            np.testing.assert_array_equal(
                PM.local_layer_flags(get_config(arch), n),
                RM.local_layer_flags(ref_get_config(arch), n))

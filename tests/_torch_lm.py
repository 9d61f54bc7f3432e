"""Shared by the LM stack's parity tests (``test_torch_lm_*.py``): the
reference's runs as numpy results, the port's on the same weights, and the
logit tolerance.

Tolerance. Logits are held at rtol 1e-4 in f32 (2e-2 in bf16) and an atol
of 1e-5 (2e-3) in units of the logits' scale, ``max(1, max |logits|)``
(about 8 at the reduced configs). A fixed atol of 1e-5 lies below the
reference's own f32 noise floor on these random-weight stacks: nudging
each entry of its f32 embedding table by one ulp moves its logits by up to
5.0e-5 (kimi, reduced; 3.3e-5 deepseek), so any independent f32
implementation misses a fixed 1e-5 on some logits near 0. The port's
largest deviation from the reference, over the ten architectures, is
5.4e-5 (seamless), about 0.6 of the scaled atol. In bf16 the reference runs
its layers as a Python loop (``scan_layers=False, remat=False``, knobs
the port does not read): under ``lax.scan`` XLA fuses the layer body and
keeps bf16 intermediates in f32 across fused ops, which moves the
reference's own logits by up to 0.12 against its unfused run; the port
rounds after every op, as the unfused run does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro.training import make_serve_step as ref_make_serve_step

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as PM
from repro_torch.training import make_serve_step

B, S, EXTRA = 2, 24, 3
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-3)}
MARGIN = 1e-3  # greedy tokens must agree where the reference's top-2 gap exceeds this


def configs(arch, dtype="float32"):
    """(reference config, port config) at ``reduced(ssm_chunk=8)``."""
    over = dict(ssm_chunk=8, dtype=dtype)
    ref = ref_get_config(arch).reduced(**over)
    if dtype == "bfloat16":
        ref = dataclasses.replace(ref, scan_layers=False, remat=False)
    return ref, get_config(arch).reduced(**over)


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype="float32"):
    """The reference at ``tests/test_serve.py``'s setup (B = 2, S = 24,
    PRNGKey(0)): its weights, inputs, ``forward`` over S + 3 tokens,
    ``prefill`` and 3 steps of its serve step fed the next 3 tokens."""
    cfg, pcfg = configs(arch, dtype)
    key = jax.random.PRNGKey(0)
    # f32: each function jitted (the reference's draws and values; its
    # eager dispatch would take most of a minute); bf16: op by op
    jit = (lambda f, **kw: jax.jit(f, **kw)) if dtype == "float32" else (lambda f, **kw: f)
    params = jit(RM.init_params, static_argnums=1)(key, cfg)
    batch = {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab_size)}
    if cfg.n_prefix_embeds:
        batch["patches"] = jax.random.normal(key, (B, cfg.n_prefix_embeds, cfg.d_model))
    if cfg.n_enc_layers:
        batch["frames"] = jax.random.normal(key, (B, 16, cfg.d_model))
    nxt = jax.random.randint(jax.random.PRNGKey(7), (B, EXTRA), 0, cfg.vocab_size)
    full = jit(RM.forward, static_argnums=2)(
        params, dict(batch, tokens=jnp.concatenate([batch["tokens"], nxt], 1)), cfg)
    logits, cache = jit(RM.prefill, static_argnums=(2, 3))(params, batch, cfg, S + EXTRA + 8)
    prefill_cache = np_tree(cache)
    serve = jit(ref_make_serve_step(cfg))
    steps = []
    for t in range(EXTRA):
        tok, lg, cache = serve(params, nxt[:, t:t + 1], cache)
        steps.append(dict(tokens=np.array(tok), logits=np.array(lg), cache=np_tree(cache)))
    return dict(cfg=cfg, pcfg=pcfg, params=np_tree(params), batch=np_tree(batch),
                next=np.array(nxt), full=np.array(full), prefill_logits=np.array(logits),
                prefill_cache=prefill_cache, steps=steps)


def port_model(run, device="cpu"):
    return convert.lm_params_from_reference(run["params"], run["pcfg"], device)


def port_batch(batch, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}


def as_np(t):
    return t.detach().float().cpu().numpy()


def assert_close(got, want, dtype="float32", msg=""):
    """``got`` against the reference's ``want`` at the dtype's tolerance,
    the atol in units of ``want``'s scale."""
    rtol, atol = TOL[dtype]
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(as_np(got) if isinstance(got, torch.Tensor) else got, want,
                               rtol=rtol, atol=atol * scale, err_msg=msg)


def assert_cache_close(got, want, dtype="float32", msg=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        if k == "len":
            np.testing.assert_array_equal(got[k].cpu().numpy(), w, err_msg=f"{msg} len")
        else:
            assert tuple(got[k].shape) == w.shape, (k, tuple(got[k].shape), w.shape)
            assert_close(got[k], w, dtype, msg=f"{msg} {k}")


def assert_tokens_agree(got, want_tokens, want_logits, msg=""):
    """Greedy tokens equal wherever the reference's top-2 gap exceeds
    MARGIN (a nearer tie may go either way under rounding)."""
    top2 = np.sort(np.asarray(want_logits, dtype=np.float32)[:, -1, :], axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    got = got.cpu().numpy().reshape(-1)
    want = np.asarray(want_tokens).reshape(-1)
    assert decided.any(), msg
    np.testing.assert_array_equal(got[decided], want[decided], err_msg=msg)


class ServeParity:
    """The port's ``prefill``, serve step, ``forward`` and ``decode_step``
    against the reference's at one architecture (``arch``, parametrized
    by the subclass), on the reference's weights."""

    dtype = "float32"

    def test_prefill_and_decode_match_the_reference(self, arch):
        run = reference_run(arch, self.dtype)
        cfg = run["pcfg"]
        model = port_model(run)
        logits, cache = PM.prefill(model, port_batch(run["batch"]), cfg, max_seq=S + EXTRA + 8)
        assert logits.dtype == torch.float32 and logits.shape == run["prefill_logits"].shape
        assert_close(logits, run["prefill_logits"], self.dtype, f"{arch} prefill")
        assert_cache_close(cache, run["prefill_cache"], self.dtype, f"{arch} prefill")
        serve = make_serve_step(cfg)
        for t, step in enumerate(run["steps"]):
            _, lg, cache = serve(model, torch.from_numpy(run["next"][:, t:t + 1]), cache)
            assert_close(lg, step["logits"], self.dtype, f"{arch} decode step {t}")
            assert_cache_close(cache, step["cache"], self.dtype, f"{arch} decode step {t}")

    def test_forward_matches_the_reference(self, arch):
        run = reference_run(arch, self.dtype)
        batch = dict(run["batch"], tokens=np.concatenate([run["batch"]["tokens"], run["next"]], 1))
        got = PM.forward(port_model(run), port_batch(batch), run["pcfg"])
        assert got.dtype == torch.float32 and got.shape == run["full"].shape
        assert_close(got, run["full"], self.dtype, f"{arch} forward")

    def test_decode_from_the_reference_cache(self, arch):
        """The reference's prefill cache carried across: the port decodes
        on from it."""
        run = reference_run(arch, self.dtype)
        model = port_model(run)
        cache = convert.lm_cache_from_reference(run["prefill_cache"], "cpu")
        for t, step in enumerate(run["steps"]):
            lg, cache = PM.decode_step(model, torch.from_numpy(run["next"][:, t:t + 1]), cache,
                                       run["pcfg"])
            assert_close(lg, step["logits"], self.dtype, f"{arch} decode step {t}")

    def test_cache_len_advances(self, arch):
        run = reference_run(arch, self.dtype)
        model = port_model(run)
        _, cache = PM.prefill(model, port_batch(run["batch"]), run["pcfg"], max_seq=S + 8)
        start = int(cache["len"][0])
        assert start == S + run["pcfg"].n_prefix_embeds == int(run["prefill_cache"]["len"][0])
        for t in range(2):
            _, cache = PM.decode_step(model, torch.from_numpy(run["next"][:, t:t + 1]), cache,
                                      run["pcfg"])
            assert cache["len"].dtype == torch.int32
            assert cache["len"].tolist() == [start + t + 1] * B

    def test_serve_step_greedy_tokens(self, arch):
        """``make_serve_step``'s greedy tokens against the reference serve
        step's, step by step on the same inputs."""
        run = reference_run(arch, self.dtype)
        cfg = run["pcfg"]
        model = port_model(run)
        serve = make_serve_step(cfg)
        cache = convert.lm_cache_from_reference(run["prefill_cache"], "cpu")
        for t, step in enumerate(run["steps"]):
            tok, lg, cache = serve(model, torch.from_numpy(run["next"][:, t:t + 1]), cache)
            assert tok.shape == (B, 1) and tok.dtype == torch.int32
            assert_tokens_agree(tok, step["tokens"], step["logits"], f"{arch} step {t}")


def check_incremental_equals_full(arch, dtype="float32"):
    """The port against itself, as ``tests/test_serve.py`` holds the
    reference (rtol 2e-2, atol 2e-3): prefill S, decode 3, each
    position's logits against ``forward`` over S + 3 tokens. Not for
    arctic: its capacity is a function of S (8 slots an expert at S = 24,
    9 at 27), so the reference's own prefill and decode differ from its
    forward (by 0.038 and up to 5.6); the port follows the reference's
    (``test_prefill_and_decode_match_the_reference``)."""
    run = reference_run(arch, dtype)
    cfg = run["pcfg"]
    model = port_model(run)
    batch = port_batch(run["batch"])
    nxt = torch.from_numpy(run["next"])
    full = PM.forward(model, dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1)), cfg)
    logits, cache = PM.prefill(model, batch, cfg, max_seq=S + EXTRA + 8)
    np.testing.assert_allclose(as_np(logits[:, 0]), as_np(full[:, S - 1]), rtol=2e-2,
                               atol=2e-3)
    for t in range(EXTRA):
        lg, cache = PM.decode_step(model, nxt[:, t:t + 1], cache, cfg)
        np.testing.assert_allclose(as_np(lg[:, 0]), as_np(full[:, S + t]), rtol=2e-2,
                                   atol=2e-3, err_msg=f"{arch} decode step {t}")

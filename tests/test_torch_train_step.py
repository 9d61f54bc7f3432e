"""The port's train step (``make_train_step``, ``init_train_state``)
against the reference's on the CPU, on the reference's weights and state
(``convert.lm_params_from_reference``, ``convert.opt_state_from_reference``):

  * one step with 2 microbatches (the f32 accumulator, clip, schedule,
    update): deepseek-7b and mamba2-130m (AdamW), internvl2-76b
    (Adafactor), at ``reduced(ssm_chunk=8)``, lr 1e-3 from step 1;
  * a step continued from the reference's state after its first step
    (AdamW's m and v carried across), one microbatch (bf16-free grads in
    the parameters' dtype);
  * three steps on one batch whose loss falls, every architecture (the
    port's ``tests/test_archs.py::test_loss_decreases_three_steps``);
  * ``tree_param_count`` against the reference's for every architecture,
    ``batch_at_step`` bit for bit and the ``PrefetchingLoader``'s order.

Tolerance: loss, grad_norm and lr at ``tests/_torch_train.py``'s; the
updated parameters and AdamW's m and v there too, less the elements
AdamW's first step leaves to rounding: its update is
``g / (|g| + eps)``, about ``sign(g)``, so where the port's gradient lies
within its own tolerance of 0 (rtol 1e-4, atol 1e-5 of the leaf's scale)
but is not 0 the two may step 2 lr apart. Those elements are counted and must be
under 2% of the leaf (0.78% of deepseek's worst leaf, 1.13% of
mamba2's read here).
"""
import jax
import numpy as np
import pytest
import torch


from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.data.lm_pipeline import PrefetchingLoader as RefLoader
from repro.data.lm_pipeline import batch_at_step as ref_batch_at_step
from repro.models import model as RM
from repro.utils import tree_param_count as ref_tree_param_count

from _torch_lm import port_batch
from _torch_train import close_ratio, flat, port_state, reference_steps, stacked
from repro_torch.configs import get_config
from repro_torch.data.lm_pipeline import PrefetchingLoader, batch_at_step
from repro_torch.models import model as PM
from repro_torch.training import init_train_state, make_train_step
from repro_torch.utils import tree_param_count

LR = 1e-3
LEFT_OUT_MAX = 0.02


def _grads(model, batch_np, cfg, microbatches):
    """The port's averaged microbatch gradient in the reference's layout."""
    names, ps = zip(*model.named_parameters())
    acc = None
    n = batch_np["tokens"].shape[0] // microbatches
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch_np.items()}
        loss, _ = PM.loss_fn(model, port_batch(mb), cfg)
        g = [x.float() for x in torch.autograd.grad(loss, ps)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    return stacked(model, {nm: a / microbatches for nm, a in zip(names, acc)})


def _check_state(model, state, want_params, want_opt, grads=None):
    """Parameters (and AdamW's m, v) against the reference's, leaving out
    the elements whose gradient lies within its tolerance of 0 when
    ``grads`` is given; returns the share left out."""
    got = stacked(model, dict(model.named_parameters()))
    worst_share = 0.0
    for path, want in flat(want_params).items():
        keep = np.ones(want.shape, bool)
        if grads is not None:
            g = grads[path]
            keep = (np.abs(g) > 1e-5 * max(1.0, float(np.abs(g).max())) + 1e-4 * np.abs(g)) | (
                g == 0)  # an unread embedding row: no gradient in either
            worst_share = max(worst_share, 1.0 - keep.mean())
        assert close_ratio(got[path][keep], want[keep]) <= 1.0, path
        leaf = state.inner[path]
        ref_leaf = _ref_leaf(want_opt, path)
        for f, t in zip(leaf._fields, leaf):
            w = np.asarray(getattr(ref_leaf, f), np.float32)
            assert tuple(t.shape) == w.shape, (path, f)
            k = keep if w.shape == keep.shape and f != "v" else np.ones(w.shape, bool)
            assert close_ratio(t.detach().numpy()[k], w[k]) <= 1.0, (path, f)
    return worst_share


def _ref_leaf(opt_np, path):
    node = opt_np.inner
    for k in path.split("/"):
        node = node[k]
    return node


@pytest.mark.parametrize("arch", ["deepseek_7b", "mamba2_130m", "internvl2_76b"])
def test_microbatched_step_matches_the_reference(arch):
    run = reference_steps(arch, 2, 1, LR, 1)
    cfg = run["pcfg"]
    model, state = port_state(run, 0)
    grads = _grads(model, run["batch"], cfg, 2) if cfg.optimizer == "adamw" else None
    step = make_train_step(cfg, microbatches=2, base_lr=LR, warmup=1)
    model, state, metrics = step(model, state, port_batch(run["batch"]))
    want_params, want_opt, want = run["states"][1]
    assert set(metrics) == set(want) == {"loss", "grad_norm", "lr", "step"}
    for k in ("loss", "grad_norm", "lr"):
        assert close_ratio(float(metrics[k]), want[k]) <= 1.0, (k, float(metrics[k]), want[k])
    assert int(metrics["step"]) == int(state.step) == 1
    share = _check_state(model, state, want_params, want_opt, grads)
    assert share < LEFT_OUT_MAX, share
    print(f"{arch}: {share:.4%} of the worst leaf left out")


def test_step_continued_from_the_reference_state():
    """The reference's state after its first step carried across; the
    port's second step (one microbatch) against the reference's second."""
    run = reference_steps("deepseek_7b", 1, 2, LR, 1)
    model, state = port_state(run, 1)
    assert int(state.step) == 1
    step = make_train_step(run["pcfg"], base_lr=LR, warmup=1)
    model, state, metrics = step(model, state, port_batch(run["batch"]))
    want_params, want_opt, want = run["states"][2]
    assert set(metrics) == set(want) == {"loss", "ppl_proxy", "grad_norm", "lr", "step"}
    for k in ("loss", "ppl_proxy", "grad_norm", "lr"):
        assert close_ratio(float(metrics[k]), want[k]) <= 1.0, k
    _check_state(model, state, want_params, want_opt)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_decreases_three_steps(arch):
    """tests/test_archs.py's criterion, on the port (lr 5e-3, warmup 1)."""
    cfg = get_config(arch).reduced()
    params, opt_state = init_train_state(2, cfg, "cpu")
    step = make_train_step(cfg, base_lr=5e-3, warmup=1)
    batch = port_batch(batch_at_step(cfg, 2, batch=2, seq_len=64, seed=2))
    losses = []
    for _ in range(3):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_the_reference(arch):
    cfg = ref_get_config(arch).reduced()
    ref = ref_tree_param_count(jax.eval_shape(lambda k: RM.init_params(k, cfg),
                                              jax.random.PRNGKey(0)))
    assert tree_param_count(PM.init_params(0, get_config(arch).reduced(), "cpu")) == ref


@pytest.mark.parametrize("arch", ["deepseek_7b", "internvl2_76b", "seamless_m4t_medium"])
def test_batch_at_step_is_the_references(arch):
    cfg, pcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    for step in (0, 3, 1000):
        want = ref_batch_at_step(cfg, step, batch=3, seq_len=40, seed=9)
        got = batch_at_step(pcfg, step, batch=3, seq_len=40, seed=9)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetching_loader_order():
    cfg = get_config("deepseek_7b").reduced()
    loader = PrefetchingLoader(cfg, batch=2, seq_len=16, seed=4, start_step=5)
    ref = RefLoader(ref_get_config("deepseek_7b").reduced(), batch=2, seq_len=16, seed=4,
                    start_step=5)
    try:
        for i in range(4):
            step, b = next(loader)
            ref_step, rb = next(ref)
            assert step == ref_step == 5 + i
            np.testing.assert_array_equal(b["tokens"], rb["tokens"])
    finally:
        loader.close()
        ref.close()

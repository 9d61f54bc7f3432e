"""The port's optimizers (``repro_torch.training.optimizers``) against the
reference's on the same numpy parameters, state and gradients, on the
CPU: AdamW (f32 parameters, which are their own master, and bf16 ones
with the f32 master) and Adafactor (factored and not, bf16 too) over
three steps, ``global_norm``, ``clip_by_global_norm`` (f32 and bf16
leaves, under and over the limit) and ``cosine_schedule`` at steps 0, 1,
warmup, total and past total; then the port's versions of
``tests/test_runtime_units.py::TestOptimizers``.

Tolerance: f32 values (new parameters, m, v, the master, Adafactor's
moments, norms and rates) at rtol 1e-6 and atol 1e-7, each f32 operation
in the reference's order (XLA and PyTorch may still round a pow or an
rsqrt a ulp apart); bf16 parameters within one bf16 ulp (2^-8 relative),
as the f32 masters they round may straddle a rounding boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizers as ref_opt

from repro_torch.training import optimizers as opt

SHAPES = {"w": (8, 16), "b": (16,), "t": (3, 4, 5)}
RTOL, ATOL = 1e-6, 1e-7


def _arrays(seed, dtype, scale=1.0):
    g = np.random.default_rng(seed)
    return {k: (g.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _to_port(arrays, dtype):
    return {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in arrays.items()}


def _to_ref(arrays, dtype):
    return {k: jnp.asarray(v, dtype=jnp.dtype(dtype)) for k, v in arrays.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32", msg=""):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0**-8, atol=0, err_msg=msg)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_reference(name, dtype):
    p0 = _arrays(0, dtype)
    params, ref_params = _to_port(p0, dtype), _to_ref(p0, dtype)
    state, ref_state = opt.init_optimizer(name, params), ref_opt.init_optimizer(name, ref_params)
    for k, leaf in state.inner.items():  # the reference's shapes, field for field
        for f, t in zip(leaf._fields, leaf):
            assert tuple(t.shape) == getattr(ref_state.inner[k], f).shape, (k, f)
    for step in range(3):
        g = _arrays(10 + step, dtype, scale=0.3)
        lr = 1e-2 * (step + 1)
        params, state = opt.apply_optimizer(name, _to_port(g, dtype), state, params,
                                            torch.tensor(lr))
        ref_params, ref_state = ref_opt.apply_optimizer(name, _to_ref(g, dtype), ref_state,
                                                        ref_params, jnp.float32(lr))
        assert int(state.step) == int(ref_state.step) == step + 1
        for k in SHAPES:
            _close(params[k], ref_params[k], dtype, f"{name} step {step} {k}")
            assert params[k].dtype == getattr(torch, dtype)
            for f, t in zip(state.inner[k]._fields, state.inner[k]):
                _close(t, getattr(ref_state.inner[k], f), msg=f"{name} step {step} {k}.{f}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_and_global_norm_match_the_reference(dtype, max_norm):
    g = _arrays(3, dtype)
    got, norm = opt.clip_by_global_norm(_to_port(g, dtype), max_norm)
    want, ref_norm = ref_opt.clip_by_global_norm(_to_ref(g, dtype), max_norm)
    _close(norm, ref_norm)
    _close(opt.global_norm(_to_port(g, dtype)), ref_opt.global_norm(_to_ref(g, dtype)))
    for k in SHAPES:
        assert got[k].dtype == getattr(torch, dtype)
        _close(got[k], want[k], dtype, k)


@pytest.mark.parametrize("step", [0, 1, 10, 57, 100, 250])
def test_cosine_schedule_matches_the_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    got = opt.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    want = ref_opt.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    assert got.dtype == torch.float32
    _close(got, want)


def test_a_model_leaf_is_the_references_stacked_leaf():
    """A model's blocks make one leaf a path, stacked on the layer axis,
    and Adafactor factors the stacked leaf as the reference does."""
    from repro_torch.configs import get_config
    from repro_torch.training import init_train_state

    cfg = get_config("deepseek_7b").reduced(n_layers=3)
    params, state = init_train_state(0, cfg, "cpu")
    assert all(p.requires_grad for p in params.parameters())
    leaf = state.inner["layers/attn/wq"]
    assert tuple(leaf.m.shape) == (3, 128, 128) and tuple(leaf.master.shape) == (1,)
    fac = opt.adafactor_init(params)
    assert tuple(fac.inner["layers/ln1/scale"].v_row.shape) == (3,)
    assert tuple(fac.inner["layers/ln1/scale"].v_col.shape) == (128,)
    assert tuple(fac.inner["final_norm/scale"].v_full.shape) == (128,)


# --- the port's versions of tests/test_runtime_units.py::TestOptimizers -------


class TestOptimizers:
    def test_adamw_moves_toward_gradient(self):
        params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        state = opt.adamw_init(params)
        grads = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        new, state = opt.adamw_update(grads, state, params, lr=0.1, weight_decay=0.0)
        assert float(new["w"][0]) < 1.0

    def test_adamw_fp32_master_used_for_bf16(self):
        params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        state = opt.adamw_init(params)
        assert tuple(state.inner["w"].master.shape) == (4,)
        state32 = opt.adamw_init({"w": torch.ones((4,))})
        assert tuple(state32.inner["w"].master.shape) == (1,)  # placeholder

    def test_adafactor_factored_shapes(self):
        state = opt.adafactor_init({"w": torch.ones((8, 16)), "b": torch.ones((16,))})
        assert tuple(state.inner["w"].v_row.shape) == (8,)
        assert tuple(state.inner["w"].v_col.shape) == (16,)
        assert tuple(state.inner["b"].v_full.shape) == (16,)

    def test_adafactor_descends_quadratic(self):
        A = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32))
        x_true = torch.ones((8, 4))
        params = {"w": torch.zeros((8, 4))}
        state = opt.adafactor_init(params)
        losses = []
        for _ in range(200):
            w = params["w"].clone().requires_grad_(True)
            loss = torch.mean((A @ w - A @ x_true) ** 2)
            (g,) = torch.autograd.grad(loss, [w])
            params, state = opt.adafactor_update({"w": g}, state, params, lr=0.05)
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.05 * losses[0]

    def test_clip_by_global_norm(self):
        clipped, norm = opt.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
        assert float(norm) == pytest.approx(20.0)
        assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)

    def test_cosine_schedule_shape(self):
        kw = dict(base_lr=1.0, warmup=10, total=100)
        lr0 = float(opt.cosine_schedule(torch.tensor(1), **kw))
        lr_mid = float(opt.cosine_schedule(torch.tensor(50), **kw))
        lr_end = float(opt.cosine_schedule(torch.tensor(100), **kw))
        assert lr0 == pytest.approx(0.1)
        assert 0.1 < lr_end < lr_mid < 1.0

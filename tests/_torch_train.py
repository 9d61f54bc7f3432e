"""Shared by the LM training parity tests (``test_torch_lm_train*.py``,
``test_torch_train_step.py``): the reference's loss and gradients, its
train steps, and the port's gradients in the reference's layout.

Tolerance. Losses and gradients are held at ``tests/_torch_lm.py``'s
scaled tolerance (rtol 1e-4, atol 1e-5 in units of each leaf's scale,
``max(1, max |g|)``): the gradients are sums over the same products in
other orders, and the port's largest deviation over the ten reduced
architectures is 0.74 of it (seamless). The batch is
``batch_at_step(cfg, 0, batch=2, seq_len=32, seed=0)`` at
``reduced(ssm_chunk=8)`` on the reference's ``PRNGKey(0)`` weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.lm_pipeline import batch_at_step as ref_batch_at_step
from repro.models import model as RM
from repro.training import init_train_state as ref_init_train_state
from repro.training import make_train_step as ref_make_train_step

from _torch_lm import configs, np_tree, port_batch, port_model
from repro_torch import convert
from repro_torch.models import model as PM
from repro_torch.training import optimizers as O

B, S = 2, 32


def path_name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                    for k in path)


def flat(tree) -> dict:
    """A reference tree's leaves as numpy arrays keyed by ``/``-joined path."""
    return {path_name(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch(cfg, step=0, b=B, s=S, seed=0):
    return ref_batch_at_step(cfg, step, batch=b, seq_len=s, seed=seed)


@functools.lru_cache(maxsize=None)
def reference_grads(arch):
    """The reference's ``loss_fn`` and its gradient on its weights."""
    cfg, pcfg = configs(arch)
    params = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    bt = batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(RM.loss_fn, has_aux=True),
                                     static_argnums=2)(params, bt, cfg)
    return dict(cfg=cfg, pcfg=pcfg, params=np_tree(params), batch=bt, loss=float(loss),
                ppl=float(metrics["ppl_proxy"]), grads=flat(grads))


def port_grads(model, batch_np, cfg):
    """The port's loss, metrics and gradient, the gradient stacked into the
    reference's layout (leaf path -> numpy)."""
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = PM.loss_fn(model, port_batch(batch_np), cfg)
    names, ps = zip(*model.named_parameters())
    g = dict(zip(names, torch.autograd.grad(loss, ps)))
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, stacked(model, g)


def stacked(model, tensors: dict) -> dict:
    """Per-parameter tensors (keyed as ``model.named_parameters()``) in
    the reference's layout: leaf path -> f32 numpy, a stack's blocks on a
    leading axis."""
    out = {}
    for path, (names, st) in O.leaf_groups(model).items():
        ts = [tensors[n].detach().float() for n in names]
        out[path] = (torch.stack(ts) if st else ts[0]).numpy()
    return out


@functools.lru_cache(maxsize=None)
def reference_steps(arch, microbatches, n_steps, base_lr, warmup):
    """The reference's train state at ``PRNGKey(1)`` and ``n_steps`` of its
    jitted ``make_train_step`` on batch 0: the initial state, and after
    each step its params, optimizer state and metrics (numpy)."""
    cfg, pcfg = configs(arch)
    params, opt = ref_init_train_state(jax.random.PRNGKey(1), cfg)
    step = jax.jit(ref_make_train_step(cfg, microbatches=microbatches, base_lr=base_lr,
                                       warmup=warmup))
    bt = batch(cfg)
    states = [(np_tree(params), np_tree(opt), None)]
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, bt)
        states.append((np_tree(params), np_tree(opt),
                       {k: float(v) for k, v in metrics.items()}))
    return dict(cfg=cfg, pcfg=pcfg, batch=bt, states=states)


def port_state(run, i, device="cpu"):
    """The port's model and optimizer state from the reference's state
    after step ``i`` (0: the initial state)."""
    params_np, opt_np, _ = run["states"][i]
    model = convert.lm_params_from_reference(params_np, run["pcfg"], device)
    for p in model.parameters():
        p.requires_grad_(True)
    return model, convert.opt_state_from_reference(opt_np, model, device)


def close_ratio(got, want, rtol=1e-4, atol=1e-5):
    """max |got - want| / (atol * max(1, max |want|) + rtol * |want|)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    return float(np.max(np.abs(np.asarray(got, np.float32) - want)
                        / (atol * scale + rtol * np.abs(want)), initial=0.0))

"""The port's ``loss_fn`` and its gradient (autograd through the blocks
under ``torch.utils.checkpoint``, the reference's remat) against the
reference's ``jax.value_and_grad(loss_fn)`` on the CPU: the dense,
GQA-with-bias, local/global and VLM architectures at ``reduced(ssm_chunk=8)``
on the reference's weights; every gradient leaf in the reference's layout
(a stack's blocks stacked). Tolerances: ``tests/_torch_train.py``. The SSM,
hybrid, MoE and encoder-decoder architectures:
``test_torch_lm_train_mixers.py``.
"""
import numpy as np
import pytest

from _torch_lm import port_model
from _torch_train import close_ratio, port_grads, reference_grads


def check_loss_and_grads(arch):
    run = reference_grads(arch)
    loss, metrics, grads = port_grads(port_model(run), run["batch"], run["pcfg"])
    assert np.isfinite(loss)
    assert close_ratio(loss, run["loss"]) <= 1.0, (loss, run["loss"])
    assert close_ratio(metrics["ppl_proxy"], run["ppl"]) <= 1.0
    assert set(grads) == set(run["grads"]), sorted(set(grads) ^ set(run["grads"]))
    for path, want in run["grads"].items():
        assert grads[path].shape == want.shape, (path, grads[path].shape, want.shape)
        r = close_ratio(grads[path], want)
        assert r <= 1.0, f"{arch} {path}: {r:.3f}x the tolerance"


@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_9b", "internlm2_20b", "qwen2_72b",
                                  "internvl2_76b"])
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
def test_card_head_backward_is_the_upcast_routes(needs):
    """The card's differentiable f32 head (``layers._MatmulF32``: a bf16
    product with an f32 output forward, whose ``torch.mm`` has no
    derivative) takes the upcast route's backward: its gradients equal
    autograd's through ``x.float() @ w.float()`` on the same cotangent, bit
    for bit (the backward runs here on the CPU; its forward only on the
    card)."""
    import types

    import torch

    from repro_torch.models.layers import _MatmulF32

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 16), generator=g).to(torch.bfloat16).requires_grad_(needs[0])
    w = torch.randn((16, 40), generator=g).to(torch.bfloat16).requires_grad_(needs[1])
    cot = torch.randn((2, 3, 40), generator=g)
    ctx = types.SimpleNamespace(saved_tensors=(x.detach(), w.detach()), needs_input_grad=needs)
    gx, gw = _MatmulF32.backward(ctx, cot)
    want = torch.autograd.grad(x.float() @ w.float(), [t for t in (x, w) if t.requires_grad],
                               cot)
    got = [t for t in (gx, gw) if t is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)

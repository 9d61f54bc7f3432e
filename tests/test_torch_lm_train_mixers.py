"""``loss_fn`` and its gradient against the reference's (as
``test_torch_lm_train.py``) for the SSM, hybrid, MoE and encoder-decoder
architectures: the SSD scan's backward, the MoE's routing with its
dispatch and combine, the encoder's memory under cross attention.
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


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b", "arctic_480b", "kimi_k2_1t_a32b",
                                  "seamless_m4t_medium"])
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)

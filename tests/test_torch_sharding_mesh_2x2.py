"""The sharding rules with real values on a (2, 2) ("data", "model") mesh of 4
gloo ranks: reduced deepseek-7b, gemma2-9b, kimi-k2 and mamba2-130m
against the plain run of the same weights, each check of
``tests/_torch_mesh_ranks.py`` (forward, prefill, decode steps and their
greedy tokens, loss_fn with its gradients, the optimizer's update, one
train step of 2 microbatches) at its f32 tolerance.
"""
import pytest

from _torch_mesh_ranks import ARCHS, CHECKS, check, run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh"), 2, 2)


@pytest.mark.parametrize("what", CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_run_is_the_plain_run(ranks, arch, what):
    check(ranks, arch, what)

"""The reference's constraint sites, restored in the port, on a gloo world
of one rank: with the parameters, batch and cache as DTensors on a (1, 1)
mesh under ``sharding.activation_mesh``, the reduced ten's ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` equal the plain run bit for
bit. Without a context every constraint returns its input. The group
lives in this module's fixture and is destroyed at its teardown.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as PM
from repro_torch.models import sharding as sh

B, S, MAX_SEQ = 2, 16, 24


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _batch(cfg, seed=0):
    g = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))}
    if cfg.n_prefix_embeds:
        batch["patches"] = torch.from_numpy(
            g.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
    if cfg.n_enc_layers:
        batch["frames"] = torch.from_numpy(g.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    return batch


def _on(mesh, tensors: dict) -> dict:
    from torch.distributed.tensor import distribute_tensor

    specs = sh.batch_specs(tensors, mesh)
    return {k: distribute_tensor(v, mesh, sh.placements(specs[k], mesh)) for k, v in tensors.items()}


def _whole(x):
    return x.full_tensor() if sh.is_dtensor(x) else x


def _same_bits(got, want, what):
    got = _whole(got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got.view(-1).view(torch.uint8) if got.is_floating_point() else got,
                       want.view(-1).view(torch.uint8) if want.is_floating_point() else want), what


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_mesh_run_is_the_plain_run(mesh, arch):
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch).reduced(ssm_chunk=8)
    params = PM.init_params(0, cfg, device="cpu")
    dparams = sh.distribute_params(copy.deepcopy(params), mesh)
    batch = _batch(cfg)
    inputs = dict(batch, tokens=batch["tokens"][:, :-1])
    prompt = dict(inputs, tokens=inputs["tokens"][:, :S - 4])
    nxt = batch["tokens"][:, S - 4:S - 3]

    with torch.no_grad():
        want_fwd = PM.forward(params, inputs, cfg)
        want_loss, _ = PM.loss_fn(params, batch, cfg)
        want_pre, cache = PM.prefill(params, prompt, cfg, MAX_SEQ)
        want_dec, _ = PM.decode_step(params, nxt, cache, cfg)

    with torch.no_grad(), sh.activation_mesh(mesh), implicit_replication():
        got_fwd = PM.forward(dparams, _on(mesh, inputs), cfg)
        got_loss, _ = PM.loss_fn(dparams, _on(mesh, batch), cfg)
        got_pre, dcache = PM.prefill(dparams, _on(mesh, prompt), cfg, MAX_SEQ)
        assert all(sh.is_dtensor(v) for k, v in dcache.items() if k != "len")
        got_dec, _ = PM.decode_step(dparams, _on(mesh, {"t": nxt})["t"], dcache, cfg)

    _same_bits(got_fwd, want_fwd, "forward")
    _same_bits(got_loss, want_loss, "loss_fn")
    _same_bits(got_pre, want_pre, "prefill")
    _same_bits(got_dec, want_dec, "decode_step")


def test_constraints_return_their_input_without_a_context():
    x = torch.ones(2, 3, 4)
    assert sh.constrain(x, "batch", "seq", "act_embed") is x
    assert sh.argmax_last(x[:, 0]).equal(torch.argmax(x[:, 0], dim=-1))
    assert sh.split_heads(x, 2, 2).shape == (2, 3, 2, 2)
    assert sh.merge_heads(sh.split_heads(x, 2, 2)).equal(x)

"""The sharding rules with real values on meshes wider than one rank: run
by ``test_torch_sharding_ranks_*.py`` as 4 gloo ranks (child processes) on
a (data, model) mesh of the CPU, each arch at ``reduced(ssm_chunk=8)``
against the plain run of the same weights on every rank.

On the mesh the parameters are DTensors as the dry run lays them out
(serving: ``fsdp=False`` and ``dryrun._serve_rules``; training:
``fsdp=True``, the optimizer state by ``dryrun.distribute_opt_state``),
the batch's rows are cut over "data", and the model runs under
``sharding.activation_mesh`` and ``implicit_replication``. Every rank
gathers each result (``full_tensor``) and records its worst error over
its allowance, ``_torch_lm.py``'s f32 tolerance: rtol 1e-4 and an atol of
1e-5 in units of ``max(1, max |want|)``; integers exactly. The partial
sums of a cut contraction add in other orders than the plain run's, so the
floats are held to that tolerance, not to their bits.

Checks, each a key of the rank's record:

- ``forward``, ``prefill`` (logits and the cache), two ``decode`` steps
  (logits and the cache) and the serve step's greedy tokens (held where
  the plain run's top-2 gap exceeds 1e-3);
- ``loss_fn`` and every parameter's gradient;
- ``opt``: each optimizer's update on the mesh from the plain gradients
  (the same values, laid out as the parameters): AdamW bit for bit (its
  ops are elementwise), Adafactor (its means sum over cut dims) at the
  tolerance;
- ``step``: one train step of 2 microbatches (the loss, the gradient norm,
  every state leaf, the parameters after). AdamW's first update is
  ``g / (|g| + eps)``, which turns a rounding of a gradient near 0 into a
  change of up to ``2 lr``: as in ``tests/_torch_train.py``, the
  parameters' elements whose gradient lies within its tolerance of 0 are
  left out of the step's check and counted (``step_left_out``); ``opt``
  holds those elements' update.

Usage: ``python tests/_torch_mesh_ranks.py WORK DATA MODEL ARCH [ARCH ...]``
(writes ``WORK/rank{r}.json``); the tests call ``run_ranks``.
"""
import contextlib
import copy
import json
import os
import sys

import subprocess
from pathlib import Path

import numpy as np
import torch

ARCHS = ["deepseek_7b", "gemma2_9b", "kimi_k2_1t_a32b", "mamba2_130m"]
CHECKS = ["forward", "prefill", "decode", "tokens", "loss_fn", "opt", "step"]
B, S, MAX_SEQ, MICRO = 4, 16, 24, 2
LR = 1e-2
RTOL, ATOL = 1e-4, 1e-5
MARGIN = 1e-3


def whole(x):
    from repro_torch.models import sharding as sh

    return x.full_tensor() if sh.is_dtensor(x) else x


def err(got, want) -> float:
    """The worst |got - want| over its allowance (<= 1 passes); integers
    and shapes must agree exactly (inf where they do not)."""
    got, want = whole(got).detach(), whole(want).detach()
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    got, want = got.double(), want.double()
    allow = ATOL * max(1.0, float(want.abs().max())) + RTOL * want.abs()
    return float(((got - want).abs() / allow).max())


def bits(got, want) -> float:
    """0 where the two are equal bit for bit, else inf."""
    got, want = whole(got).detach(), whole(want).detach()
    same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(
        got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
    return 0.0 if same else float("inf")


def make_batch(cfg):
    g = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))}


def on_mesh(mesh, tensors: dict) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import sharding as sh

    specs = sh.batch_specs(tensors, mesh)
    return {k: distribute_tensor(v, mesh, sh.placements(specs[k], mesh)) for k, v in tensors.items()}


def worst(rec: dict, key: str, value: float, where: str = "") -> None:
    """Keep the largest reading under ``key`` and where it was."""
    if value > rec.get(key, (-1.0, ""))[0]:
        rec[key] = (value, where)


def check_arch(arch: str, mesh) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as PM
    from repro_torch.models import sharding as sh
    from repro_torch.training import optimizers as O
    from repro_torch.training.train_step import make_serve_step, make_train_step

    cfg = get_config(arch).reduced(ssm_chunk=8)
    params = PM.init_params(0, cfg, device="cpu")
    batch = make_batch(cfg)
    inputs = {"tokens": batch["tokens"][:, :-1]}
    prompt = {"tokens": inputs["tokens"][:, :S - 4]}
    nxt = [batch["tokens"][:, S - 4 + t:S - 3 + t] for t in range(2)]
    rec: dict = {}

    @contextlib.contextmanager
    def meshed():
        with sh.activation_mesh(mesh), implicit_replication():
            yield

    # -- serving: forward, prefill, two decode steps, the greedy tokens
    serve = make_serve_step(cfg)
    sp = sh.distribute_params(copy.deepcopy(params), mesh, fsdp=False,
                              rules=dryrun._serve_rules(arch))
    with torch.no_grad():
        want_fwd = PM.forward(params, inputs, cfg)
        want_pre, cache = PM.prefill(params, prompt, cfg, MAX_SEQ)
        want_pre_cache = {k: v.clone() for k, v in cache.items()}
        want_dec = []
        for tok in nxt:
            toks, lg, cache = serve(params, tok, cache)
            want_dec.append((toks, lg, {k: v.clone() for k, v in cache.items()}))
    with torch.no_grad(), meshed():
        worst(rec, "forward", err(PM.forward(sp, on_mesh(mesh, inputs), cfg), want_fwd))
        got_pre, dcache = PM.prefill(sp, on_mesh(mesh, prompt), cfg, MAX_SEQ)
        worst(rec, "prefill", err(got_pre, want_pre), "logits")
        for k, v in want_pre_cache.items():
            worst(rec, "prefill", err(dcache[k], v), k)
        for t, (tok, (toks, lg, want_cache)) in enumerate(zip(nxt, want_dec)):
            got_toks, got_lg, dcache = serve(sp, on_mesh(mesh, {"t": tok})["t"], dcache)
            worst(rec, "decode", err(got_lg, lg), f"logits {t}")
            for k, v in want_cache.items():
                worst(rec, "decode", err(dcache[k], v), f"{k} {t}")
            top2 = torch.topk(lg[:, -1], 2, dim=-1).values
            held = (top2[:, 0] - top2[:, 1]) > MARGIN
            same = torch.equal(whole(got_toks)[held], toks[held])
            worst(rec, "tokens", 0.0 if same else float("inf"), f"step {t}")
            rec["tokens_held"] = rec.get("tokens_held", 0) + int(held.sum())

    # -- loss_fn and its gradients, the train layout
    for p in params.parameters():
        p.requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    tp = sh.distribute_params(copy.deepcopy(params), mesh, fsdp=True)
    loss, _ = PM.loss_fn(params, batch, cfg)
    grads = dict(zip(names, torch.autograd.grad(loss, list(params.parameters()))))
    with meshed():
        got_loss, _ = PM.loss_fn(tp, on_mesh(mesh, batch), cfg)
        got_grads = torch.autograd.grad(got_loss, list(tp.parameters()))
    worst(rec, "loss_fn", err(got_loss, loss), "loss")
    for n, g in zip(names, got_grads):
        worst(rec, "loss_fn", err(g, grads[n]), n)

    # -- the optimizer on the mesh from the same gradients
    exact = cfg.optimizer == "adamw"
    plain, dist_p = copy.deepcopy(params), copy.deepcopy(tp)
    state = O.init_optimizer(cfg.optimizer, plain)
    dstate = dryrun.distribute_opt_state(O.init_optimizer(cfg.optimizer, params), params, mesh)
    dgrads = {}
    for n, p in dist_p.named_parameters():
        dgrads[n] = dryrun._distribute(grads[n].detach(), mesh, ())
        dgrads[n] = dgrads[n].redistribute(p.device_mesh, p.placements)
    lr = torch.tensor(LR)
    O.apply_optimizer(cfg.optimizer, {n: g.detach() for n, g in grads.items()}, state, plain, lr)
    with meshed():
        O.apply_optimizer(cfg.optimizer, dgrads, dstate, dist_p, lr)
    same = bits if exact else err
    for n, p in plain.named_parameters():
        worst(rec, "opt", same(dist_p.get_parameter(n), p), n)
    for path, leaf in state.inner.items():
        for field, t in zip(leaf._fields, leaf):
            worst(rec, "opt", same(getattr(dstate.inner[path], field), t), f"{path}/{field}")

    # -- one train step of 2 microbatches
    step = make_train_step(cfg, microbatches=MICRO, base_lr=LR, warmup=1)
    plain, dist_p = copy.deepcopy(params), copy.deepcopy(tp)
    state = O.init_optimizer(cfg.optimizer, plain)
    dstate = dryrun.distribute_opt_state(O.init_optimizer(cfg.optimizer, params), params, mesh)
    plain, state, m = step(plain, state, batch)
    with meshed():
        dist_p, dstate, dm = step(dist_p, dstate, on_mesh(mesh, batch))
    for k in ("loss", "grad_norm"):
        worst(rec, "step", err(dm[k], m[k]), k)
    worst(rec, "step", err(dstate.step, state.step), "step")
    for path, leaf in state.inner.items():
        for field, t in zip(leaf._fields, leaf):
            worst(rec, "step", err(getattr(dstate.inner[path], field), t), f"{path}/{field}")
    left, total = 0, 0
    groups = O.leaf_groups(plain)
    for path, (pnames, stacked) in groups.items():
        for i, n in enumerate(pnames):
            want, got = plain.get_parameter(n).detach(), whole(dist_p.get_parameter(n)).detach()
            held = torch.ones_like(want, dtype=torch.bool)
            if exact:  # AdamW: the clipped gradient from m = (1 - b1) g
                mt = state.inner[path].m
                g = (mt[i] if stacked else mt) / 0.1
                held = (g == 0) | (g.abs() > ATOL * max(1.0, float(g.abs().max())))
            left += int((~held).sum())
            total += want.numel()
            worst(rec, "step", err(got[held], want[held]), n)
    rec["step_left_out"] = (left, total)
    return rec


def run(rank: int, work: str, data: int, model: int, archs) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "init"),
                            world_size=4, rank=rank)
    mesh = make_host_mesh(data, model, device="cpu")
    out = {}
    for arch in archs:
        try:
            out[arch] = check_arch(arch, mesh)
        except Exception as e:  # noqa: BLE001 — recorded, the test reports it
            import traceback

            out[arch] = {"error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(work: Path, data: int, model: int, archs=ARCHS) -> list:
    """The 4 ranks' records (``[{arch: record}]``), from a child process
    that spawns them on a (data, model) mesh."""
    env = {"PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp"),
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    proc = subprocess.run([sys.executable, __file__, str(work), str(data), str(model), *archs],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(4)]


def check(ranks: list, arch: str, what: str) -> None:
    """Every rank's reading of ``what`` within its allowance."""
    for r, out in enumerate(ranks):
        rec = out[arch]
        assert "error" not in rec, rec.get("traceback", rec)
        value, where = rec[what]
        assert value <= 1.0, f"rank {r}: {arch} {what} at {where}: {value:.3g} of the tolerance"
        if what == "tokens":
            assert rec["tokens_held"] > 0
        if what == "step":
            left, total = rec["step_left_out"]
            assert left < 0.05 * total, (left, total)


if __name__ == "__main__":
    import torch.multiprocessing as mp

    work, data, model, *archs = sys.argv[1:]
    mp.spawn(run, args=(work, int(data), int(model), archs), nprocs=4, join=True)

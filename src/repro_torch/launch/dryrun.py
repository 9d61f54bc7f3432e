"""Multi-pod dry run (the port of ``repro.launch.dryrun``): every (arch x
shape x mesh) cell's step run once on fake tensors (``FakeTensorMode``:
shapes and dtypes, no memory) over a fake process group of the production
world size (256 or 512 ranks), under DTensor, recording memory, one rank's
costs and collective tallies for the roofline with H100 figures.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod both] [--device cpu]
Outputs JSON per cell under experiments/dryrun_torch/ (``--out``).

What stands for the reference's compile: the parameters, optimizer
state, batch and cache are distributed on the production mesh by the
ported specs (``models.sharding``), and the cell's step (``make_train_step``
with its optimizer update, ``make_prefill_step`` or ``make_serve_step``)
runs once under ``sharding.activation_mesh``. Plain tensors that the
model builds inside its functions (RoPE tables, masks, positions) are the
same on every rank and go in as replicated (``implicit_replication``).
``analysis.roofline.CostMode`` counts each rank's local ops: the FLOPs
that ``torch.utils.flop_counter`` counts (products, attention,
convolutions; XLA's ``cost_analysis`` also counts elementwise work),
eager's bytes (each op's operands read and results written) and the
collectives DTensor issues. ``--device`` is the fake tensors' device:
'cuda' (the default; no card is needed) or 'cpu'. On 'cpu' DTensor moves
a shard from one dimension to another by an all-gather (gloo has no
all-to-all), which the tally then counts as one.

The costs are counted, as the reference counts them, by the two-point
depth probe (``_probe_costs``): two shallower copies of the stack run
and the counts are extrapolated linearly in depth, exact for uniform
stacks (a stack no deeper than the deeper copy runs whole). The
temporaries' peak is extrapolated the same way.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import roofline as rf
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cells as cell_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as sh
from repro_torch.training import optimizers as opt_lib
from repro_torch.training.train_step import make_prefill_step, make_serve_step, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


def _run_without_modes(fn):
    def wrapped(*args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            return fn(*args, **kwargs)

    wrapped._without_modes = True
    return wrapped


def _patch_strided_shard() -> None:
    """A ``_StridedShard`` (two sharded dims flattened into one, as a batched
    product's operands are) computes its local size with index tensors and
    reads them back (``tolist``), which a fake tensor cannot: run that index
    arithmetic on real CPU tensors, outside every mode. Done once a
    process."""
    from torch.distributed.tensor.placement_types import _StridedShard

    fn = _StridedShard.local_shard_size_and_offset
    if not getattr(fn, "_without_modes", False):
        _StridedShard.local_shard_size_and_offset = _run_without_modes(fn)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process is
    rank 0; its collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _patch_strided_shard()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------


def _opt_shardings(opt_spec, params_spec, mesh, fsdp, rules=None):
    """Optimizer-state specs derived from the param specs: an ``OptState``
    whose leaves are specs. A stacked leaf (a layer stack's) takes its
    parameters' spec behind a leading None."""
    pspecs = sh.param_specs(params_spec, mesh, fsdp=fsdp, rules=rules)
    groups = opt_lib.leaf_groups(params_spec)

    def map_state(path, state_leaf):
        names, stacked = groups[path]
        pspec = ((None,) if stacked else ()) + tuple(pspecs[names[0]])
        if isinstance(state_leaf, opt_lib.AdamLeaf):
            master = pspec if state_leaf.master.dim() == len(pspec) else (None,)
            return opt_lib.AdamLeaf(m=pspec, v=pspec, master=master)
        if isinstance(state_leaf, opt_lib.FactorLeaf):
            parts = list(pspec)
            row = tuple(parts[:-1]) if state_leaf.v_row.dim() == len(parts) - 1 else (None,)
            col = (tuple(parts[:-2] + parts[-1:]) if state_leaf.v_col.dim() == len(parts) - 1
                   else (None,))
            full = tuple(parts) if state_leaf.v_full.dim() == len(parts) else (None,)
            return opt_lib.FactorLeaf(v_row=row, v_col=col, v_full=full)
        raise TypeError(type(state_leaf))

    inner = {path: map_state(path, leaf) for path, leaf in opt_spec.inner.items()}
    return opt_lib.OptState(step=(), inner=inner)


def _serve_rules(arch: str):
    if arch in cell_lib.SERVE_MLP_DATA:
        rules = dict(sh.DEFAULT_RULES)
        rules["mlp"] = "data"
        rules["moe_mlp"] = "data"  # expert weights shard F over data too
        return rules
    return None


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in sh.mesh_shape(mesh))


def _distribute(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, sh.placements(spec, mesh), src_data_rank=None)


def distribute_opt_state(opt_state, params, mesh, fsdp: bool = True):
    """``opt_state`` (the optimizer's state of ``params``, whose every rank
    holds it whole) as DTensors laid out by ``_opt_shardings``: this rank's
    shard of each leaf, no collective."""
    specs = _opt_shardings(opt_state, params, mesh, fsdp=fsdp)
    inner = {path: type(leaf)(*(_distribute(t, mesh, s) for t, s in zip(leaf, specs.inner[path])))
             for path, leaf in opt_state.inner.items()}
    return opt_lib.OptState(step=_distribute(opt_state.step, mesh, ()), inner=inner)


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _tensors(tree):
    """The tensors of a tree of arguments or results, a model's parameters
    included."""
    from torch.utils._pytree import tree_flatten

    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def lower_cell(arch: str, shape_name: str, mesh, *, cfg_override=None, device: str = "cuda",
               shape=None, microbatches=None):
    """``(run, meta, cfg, shape, args)`` for one cell, under the caller's
    fake mode: ``run()`` runs the cell's step once on ``args``, the
    distributed stand-ins (parameters, optimizer state, batch, cache).
    ``shape`` and ``microbatches`` override the cell's (the small shapes of
    the tests)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape or cell_lib.SHAPES[shape_name]
    params = cell_lib.params_spec_for(cfg, device=device)

    if shape.kind == "train":
        dp = math.prod(sh.mesh_shape(mesh)[a] for a in _dp_axes(mesh))
        mb = microbatches or min(cell_lib.TRAIN_MICROBATCHES[arch], max(shape.global_batch // dp, 1))
        for p in params.parameters():
            p.requires_grad_(True)
        opt_state = distribute_opt_state(cell_lib.opt_spec_for(cfg, params), params, mesh)
        sh.distribute_params(params, mesh, fsdp=True)
        batch = cell_lib.batch_specs_for(cfg, shape, device=device)
        bspecs = sh.batch_specs(batch, mesh)
        batch = {k: _distribute(v, mesh, bspecs[k]) for k, v in batch.items()}
        step = make_train_step(cfg, microbatches=mb, dp_axes=_dp_axes(mesh))
        args = (params, opt_state, batch)
        meta = {"microbatches": mb, "fsdp": True}
    elif shape.kind == "prefill":
        sh.distribute_params(params, mesh, fsdp=False, rules=_serve_rules(arch))
        batch = cell_lib.batch_specs_for(cfg, shape, device=device)
        bspecs = sh.batch_specs(batch, mesh)
        batch = {k: _distribute(v, mesh, bspecs[k]) for k, v in batch.items()}
        step = make_prefill_step(cfg, max_seq=shape.seq_len)
        args = (params, batch)
        meta = {"fsdp": False, "serve_rules": arch in cell_lib.SERVE_MLP_DATA}
    else:  # decode
        sh.distribute_params(params, mesh, fsdp=False, rules=_serve_rules(arch))
        tokens, cache = cell_lib.decode_inputs_for(cfg, shape, device=device)
        cspecs = sh.cache_specs(cache, mesh)
        cache = {k: _distribute(v, mesh, cspecs[k]) for k, v in cache.items()}
        # falls back to replication when batch < dp (long_500k B=1)
        tokens = _distribute(tokens, mesh, sh.spec_for(tuple(tokens.shape), ("batch", None), mesh,
                                                       sh.DEFAULT_RULES))
        step = make_serve_step(cfg)
        args = (params, tokens, cache)
        meta = {"fsdp": False, "serve_rules": arch in cell_lib.SERVE_MLP_DATA}

    def run():
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return step(*args)

    return run, meta, cfg, shape, args


def _count(arch, shape_name, mesh, *, cfg_override, device, shape, microbatches):
    """One fake run of the cell: ``(CostMode, meta, cfg, shape, argument
    bytes, output bytes)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        run, meta, cfg, shape, args = lower_cell(
            arch, shape_name, mesh, cfg_override=cfg_override, device=device, shape=shape,
            microbatches=microbatches)
        arg_bytes = _local_bytes(_tensors(args))
        with rf.CostMode() as mode:
            out = run()
        out_bytes = _local_bytes(_tensors(out))
    return mode, meta, cfg, shape, arg_bytes, out_bytes


def _depths(cfg):
    """(decoder layers past a MoE's dense prefix, the prefix, the probe's
    two depths), as the reference's ``_probe_costs`` picks them."""
    prefix = cfg.first_k_dense if cfg.n_experts else 0
    L_main = cfg.n_layers - prefix
    period = max(len(cfg.layer_pattern), 1)
    return L_main, prefix, min(2 * period, L_main), min(4 * period, L_main)


def _at_depth(cfg, Lk: int, L_main: int, prefix: int):
    n_enc = max(1, round(cfg.n_enc_layers * Lk / L_main)) if cfg.n_enc_layers else 0
    return dataclasses.replace(cfg, n_layers=Lk + prefix, n_enc_layers=n_enc,
                               global_layer_indices=(0,) if cfg.global_layer_indices else ())


def _probe_costs(arch: str, shape_name: str, mesh, *, device: str = "cuda", cfg_override=None,
                 shape=None, microbatches=None):
    """``(RooflineTerms, temp bytes, meta, cfg, shape, argument bytes, output
    bytes)``: one rank's counts of the cell's step.

    The reference's two-point depth probe: the step at two depths L1 < L2 of
    its stack (the MoE dense prefix, the embedding, head and optimizer land
    in the intercept), extrapolated linearly to the full depth; exact for
    uniform stacks. A stack no deeper than L2 is counted whole. The probe
    runs the real microbatch count (the reference's runs one), so the
    temporaries' peak and the output bytes extrapolate from the same runs;
    the argument bytes are the full-depth stand-ins'."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    L_main, prefix, L1, L2 = _depths(cfg)

    def measure(cfg_k):
        mode, meta, _, shp, arg_b, out_b = _count(
            arch, shape_name, mesh, cfg_override=cfg_k, device=device, shape=shape,
            microbatches=microbatches)
        return (mode.flops, mode.bytes, mode.tallies, float(mode.peak_bytes), out_b), meta, shp, arg_b

    if L2 == L_main:
        (flops, bytes_acc, tallies, temp, out_b), meta, shp, arg_b = measure(cfg)
    else:
        (f2, b2, t2, p2, o2), meta, shp, _ = measure(_at_depth(cfg, L2, L_main, prefix))
        (f1, b1, t1, p1, o1), _, _, _ = measure(_at_depth(cfg, L1, L_main, prefix))
        scale = (L_main - L2) / (L2 - L1)
        flops, bytes_acc, temp, out_b = (
            a2 + (a2 - a1) * scale for a1, a2 in ((f1, f2), (b1, b2), (p1, p2), (o1, o2)))
        tallies = {kind: {k: t2[kind][k] + (t2[kind][k] - t1[kind][k]) * scale for k in t2[kind]}
                   for kind in t2}
        arg_b = _argument_bytes(arch, shape_name, mesh, cfg, device, shape, microbatches)
    return (rf.terms_from_counts(flops, bytes_acc, tallies, rf.H100), temp, meta, cfg, shp,
            arg_b, out_b)


def _argument_bytes(arch, shape_name, mesh, cfg, device, shape, microbatches) -> int:
    """The full-depth cell's argument bytes (its distributed stand-ins'),
    with no step run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = lower_cell(arch, shape_name, mesh, cfg_override=cfg, device=device, shape=shape,
                          microbatches=microbatches)[4]
        return _local_bytes(_tensors(args))


def run_cell(arch: str, shape_name: str, multi_pod: bool, save_hlo: bool = False, *,
             device: str = "cuda", mesh=None, cfg_override=None, shape=None,
             microbatches=None) -> dict:
    """The cell's record, in the reference's layout. Under a fake group of
    the production world size that it starts and tears down, unless a
    ``mesh`` is given (the caller's group; the tests' small meshes).
    ``save_hlo`` is the reference's flag: the port has no HLO and ignores
    it."""
    del save_hlo
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_name = "x".join(str(n) for n in mesh.shape)
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok"}
    skip = cell_lib.cell_skip_reason(arch, shape_name)
    if skip and shape is None:
        record["status"] = "skipped"
        record["reason"] = skip
        return record
    world = contextlib.nullcontext() if mesh is not None else fake_world(512 if multi_pod else 256)
    try:
        with world:
            if mesh is None:
                mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            n_chips = mesh.size()
            with sh.activation_mesh(mesh):
                t_lower = time.time() - t0
                t_probe0 = time.time()
                terms, temp, meta, cfg, shape, arg_b, out_b = _probe_costs(
                    arch, shape_name, mesh, device=device, cfg_override=cfg_override,
                    shape=shape, microbatches=microbatches)
                t_probe = time.time() - t_probe0
        mflops = rf.model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
        hlo_total_flops = terms.flops_per_device * n_chips
        record.update(meta)
        record.update({
            "device": device,
            "full_depth": _depths(cfg)[3] == _depths(cfg)[0],  # else extrapolated
            "lower_s": round(t_lower, 1),
            "compile_s": None,  # nothing is compiled: the step runs eagerly on fake tensors
            "probe_s": round(t_probe, 1),
            "memory": {
                "argument_size": arg_b,
                "output_size": out_b,
                "temp_size": temp,
                "generated_code_size": None,
            },
            "roofline": terms.to_dict(),
            "model_flops_total": mflops,
            "hlo_flops_total": hlo_total_flops,
            "useful_flops_ratio": mflops / max(hlo_total_flops, 1.0),
            "hbm_per_device_gb": ((arg_b or 0) + (temp or 0)) / 1e9,
        })
    except Exception as e:  # noqa: BLE001 — record and continue
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 1)
    return record


def summary(rec: dict) -> str:
    """One line of a record, as ``main`` prints it."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']} compute={r['compute_s']:.4g}s"
                 f" memory={r['memory_s']:.4g}s collective={r['collective_s']:.4g}s"
                 f" hbm/dev={rec['hbm_per_device_gb']:.2f}GB"
                 f" useful={rec['useful_flops_ratio']:.3f} probe={rec['probe_s']}s")
    elif status == "error":
        extra = f" ERROR {rec['error'][:200]}"
    return f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: {status}{extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(cell_lib.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", choices=["no", "yes", "both"], default="no")
    ap.add_argument("--save-hlo", action="store_true", help="the reference's flag; no effect")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (no card is needed for 'cuda')")
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multipod]
    if args.all:
        cells = [(a, s) for a, s, _ in cell_lib.iter_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    errors = 0
    for arch, shape in cells:
        for mp in pods:
            mesh_name = "2x16x16" if mp else "16x16"
            out = args.out / f"{arch}_{shape}_{mesh_name}.json"
            if args.skip_existing and out.exists():
                prev = json.loads(out.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[skip existing] {out.name}")
                    continue
            print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
            rec = run_cell(arch, shape, mp, device=args.device)
            out.write_text(json.dumps(rec, indent=2, default=str))
            errors += rec["status"] == "error"
            print(summary(rec), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Small-scale shakeout of the port's dry-run path (the port of
``scripts/debug_dryrun_small.py``): 8 fake ranks on a (2, 4) ("data",
"model") mesh, the reduced configs at tiny shapes, through the same
``launch.dryrun.run_cell`` as the production cells.

    PYTHONPATH=src python scripts/torch_debug_dryrun_small.py [--device cpu]
        [--arch deepseek_7b ...] [--kinds train prefill decode] [--mesh 2 4]

Prints one line a cell and exits 1 if any failed. ``--device`` is the fake
tensors' device: 'cuda' needs no card, 'cpu' is what a CPU-only build of
PyTorch can run.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import ShapeSpec  # noqa: E402

SMALL_SHAPES = {
    "train": ShapeSpec("train", "train", 64, 8),
    "prefill": ShapeSpec("prefill", "prefill", 128, 8),
    "decode": ShapeSpec("decode", "decode", 128, 8),
}
MICROBATCHES = 2


def small_cells(archs, kinds, mesh, device):
    """The records of ``archs`` x ``kinds`` on ``mesh`` (the caller's fake
    group)."""
    out = []
    for arch in archs:
        cfg = get_config(arch).reduced(ssm_chunk=16)
        for kind in kinds:
            out.append(dryrun.run_cell(arch, kind, False, device=device, mesh=mesh,
                                       cfg_override=cfg, shape=SMALL_SHAPES[kind],
                                       microbatches=MICROBATCHES))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--arch", nargs="*", choices=ARCH_IDS, default=list(ARCH_IDS))
    ap.add_argument("--kinds", nargs="*", choices=list(SMALL_SHAPES), default=list(SMALL_SHAPES))
    ap.add_argument("--mesh", nargs=2, type=int, default=(2, 4), metavar=("DATA", "MODEL"))
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_host_mesh

    data, model = args.mesh
    fails = 0
    with dryrun.fake_world(data * model):
        mesh = make_host_mesh(data, model, device=args.device)
        for rec in small_cells(args.arch, args.kinds, mesh, args.device):
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"OK   {rec['arch']:22s} {rec['shape']:8s} {rec['total_s']:5.1f}s "
                      f"flops/dev={r['flops_per_device']:.2e} "
                      f"wire={r['wire_bytes_per_device']:.2e}", flush=True)
            else:
                fails += 1
                print(f"FAIL {rec['arch']:22s} {rec['shape']:8s} {rec.get('error', '')[:300]}",
                      flush=True)
                print(rec.get("traceback", "")[-1500:], flush=True)
    print(f"\n{fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"{time.time() - t0:.1f} s")
    sys.exit(rc)

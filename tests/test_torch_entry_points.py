"""The port's examples and CI scripts (``examples/torch_*.py``,
``scripts/torch_*.py``) on the CPU at small sizes: each ``main(argv)`` runs
with ``--device cpu`` and returns its exit code and the numbers it printed;
none of the seven (nor the telemetry smoke's cost split) imports JAX or
the reference; without ``--device`` they ask for the card and refuse the
CPU.

The quickstart's FW, CD and FISTA numbers are held against the reference
functions it mirrors (``fw_solve``, ``baselines.cd_solve``,
``baselines.fista_solve``) on the same data and streams: the FW solves on
the reference's index stream (its key split every step, drawn inside
``jax.threefry_partitionable(False)``, ROADMAP.md Queue 3 R1), FISTA's
power iteration from the reference's start vector. Iterations, dot counts
and supports exact, objectives at rtol 1e-5 (sums in another order). The
report's trace passes the port's ``validate_chrome_trace`` and the scraped
OpenMetrics text its ``validate_openmetrics``; the chaos matrix holds its
CPU expectations (rung 3 falls back).
"""
import ast
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CDConfig as RefCD
from repro.core import FISTAConfig as RefFISTA
from repro.core import FWConfig as RefFW
from repro.core import baselines as ref_baselines
from repro.core import fw_solve as ref_fw_solve
from repro.data.synthetic import paper_synthetic as ref_paper_synthetic

from repro_torch import convert

REPO = Path(__file__).resolve().parents[1]
FILES = {
    "quickstart": REPO / "examples" / "torch_quickstart.py",
    "fullpath": REPO / "examples" / "torch_lasso_fullpath_4m.py",
    "family": REPO / "examples" / "torch_solver_family.py",
    "report": REPO / "scripts" / "torch_solver_report.py",
    "telemetry": REPO / "scripts" / "torch_telemetry_smoke.py",
    "chaos": REPO / "scripts" / "torch_chaos_smoke.py",
    "profile": REPO / "scripts" / "torch_profile_capture.py",
    "split": REPO / "scripts" / "torch_telemetry_split.py",
    "serve_lm": REPO / "examples" / "torch_serve_lm.py",
    "serve": REPO / "src" / "repro_torch" / "launch" / "serve.py",
    "train_lm": REPO / "examples" / "torch_train_lm.py",
    "fw_probe": REPO / "examples" / "torch_fw_feature_selection.py",
    "compressed_dp": REPO / "examples" / "torch_compressed_dp.py",
    "train": REPO / "src" / "repro_torch" / "launch" / "train.py",
    "dryrun": REPO / "src" / "repro_torch" / "launch" / "dryrun.py",
    "dryrun_small": REPO / "scripts" / "torch_debug_dryrun_small.py",
}
QS_P, QS_INF, QS_ITERS = 300, 10, 150


def _load(name):
    """The file as a module of its own name (its ``main`` and helpers)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(f"torch_entry_{name}", FILES[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(FILES))
def test_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse(FILES[name].read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots or name in ("telemetry", "report")
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal is for a machine without a card")
@pytest.mark.parametrize("name", ["quickstart", "fullpath", "family", "chaos", "profile",
                                  "report", "serve_lm", "serve", "train_lm", "fw_probe",
                                  "compressed_dp", "train"])
def test_asks_for_the_card_by_default(name, tmp_path):
    """No silent CPU fallback: without ``--device`` each asks for the card."""
    argv = {"report": ["--out-dir", str(tmp_path), "--backends", "torch"],
            "chaos": ["--out", str(tmp_path / "c.json")],
            "profile": ["--out", str(tmp_path)],
            "serve": ["--arch", "deepseek_7b", "--reduced"],
            "train": ["--arch", "deepseek_7b", "--reduced", "--ckpt-dir", str(tmp_path)],
            "train_lm": ["--ckpt-dir", str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)


def _ref_stream(n_steps, p, kappa, key):
    with jax.threefry_partitionable(False):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.randint(sub, (kappa,), 0, p)

        return np.asarray(jax.lax.scan(body, key, None, length=n_steps)[1])


def test_quickstart_matches_the_reference_functions():
    """The quickstart's CD, FISTA and FW solves (deterministic and
    stochastic) against the reference's on the same data and streams."""
    qs = _load("quickstart")
    key = jax.random.PRNGKey(0)
    kappa = 194
    with jax.threefry_partitionable(False):
        stream = _ref_stream(QS_ITERS, QS_P, kappa, key)
        v0 = torch.tensor(np.asarray(jax.random.normal(key, (QS_P,))))

    def sampler_fn(sampling):
        return convert.stream_from_reference(stream if sampling == "uniform" else stream[:0],
                                             "cpu")

    got = qs.run("cpu", QS_P, QS_INF, points=2, max_iters=QS_ITERS, sampler_fn=sampler_fn,
                 v0=v0, log=lambda *a: None)
    ds = ref_paper_synthetic(QS_P, QS_INF, seed=0)
    Xt, y = jnp.asarray(np.ascontiguousarray(ds.X.T)), jnp.asarray(ds.y)
    from repro.core import path as ref_path

    lam = float(ref_path.lambda_grid(Xt, y, n_points=10)[3])
    with jax.threefry_partitionable(False):
        cd = ref_baselines.cd_solve(Xt, y, RefCD(lam=lam, max_sweeps=300, tol=1e-6), key)
        fista = ref_baselines.fista_solve(Xt, y, RefFISTA(lam=lam, max_iters=300, tol=1e-3), key)
        delta = float(jnp.sum(jnp.abs(cd.alpha)))
        fws = {s: ref_fw_solve(Xt, y, RefFW(delta=delta, kappa=kappa, sampling=s,
                                            max_iters=QS_ITERS, tol=1e-4), key)
               for s in ("full", "uniform")}
    assert got["cd_active"] == int(cd.active)
    np.testing.assert_allclose(got["cd_objective"], float(cd.objective), rtol=1e-5)
    np.testing.assert_allclose(got["delta"], delta, rtol=1e-5)
    assert (got["fista_iters"], got["fista_active"]) == (int(fista.iterations),
                                                          int(fista.active))
    np.testing.assert_allclose(got["fista_objective"], float(fista.objective), rtol=1e-5)
    for s, ref in fws.items():
        mine = got[f"fw_{s}"]
        assert (mine["iterations"], mine["n_dots"], mine["active"]) == (
            int(ref.iterations), int(ref.n_dots), int(ref.active)), s
        np.testing.assert_allclose(mine["objective"], float(ref.objective), rtol=1e-5,
                                   err_msg=s)
    assert got["fw_path_dots"] > 0 and got["cd_path_dots"] > 0


@pytest.mark.parametrize("backend,driver,extra", [
    ("torch", "batched", []), ("torch", "sequential", []),
    ("sparse", "batched", ["--density", "0.05"]), ("sparse", "sequential", ["--density", "0.05"])])
def test_fullpath_runs_on_cpu(backend, driver, extra):
    rc, out = _load("fullpath").main(["--device", "cpu", "--p", "3000", "--m", "100",
                                      "--points", "4", "--backend", backend, "--driver", driver,
                                      *extra])
    assert rc == 0 and out["points"] == 4 and out["card"] == "cpu"
    assert out["total_iters"] > 0 and np.isfinite(out["densest_objective"])


def test_solver_family_runs_on_cpu():
    rc, out = _load("family").main(["--device", "cpu", "--scale", "0.002", "--points", "3",
                                    "--max-iters", "150"])
    assert rc == 0
    for name in ("lasso", "logistic", "elastic-net l2=1"):
        np.testing.assert_allclose(out[f"{name}/torch"]["objective"],
                                   out[f"{name}/sparse"]["objective"], rtol=1e-4)
    assert out["colstats_diff"] == (0.0, 0.0)  # the kernel's plain version on the CPU
    assert all(out[f"path/{n}"]["points"] == 3 for n in ("lasso", "logistic", "elastic-net"))


def test_solver_report_artifacts_validate(tmp_path):
    """Three backends and the (1, 4) mesh of 4 gloo ranks in a child process:
    the trace and the report on disk pass the port's validators."""
    from repro_torch.obs import validate_chrome_trace

    rc, out = _load("report").main(["--out-dir", str(tmp_path), "--iters", "60", "--distributed",
                                    "--device", "cpu"])
    assert rc == 0
    assert set(out) == {"lasso_torch", "lasso_kernels", "lasso_sparse", "lasso_distributed_1x4"}
    assert out["lasso_torch"]["iterations"] == 60
    assert not validate_chrome_trace((tmp_path / "solver_trace.json").read_text())
    report = json.loads((tmp_path / "solver_report.json").read_text())
    assert {r["backend"] for r in report["runs"]} == {"torch", "kernels", "sparse",
                                                       "distributed"}
    assert (tmp_path / "solver_report.md").exists()


def test_telemetry_smoke_gates_on_cpu(tmp_path):
    """The smoke's five gates run: the artifacts (gates 1-2) pass and the
    overheads are measured (gates 3 and 5; on the CPU the plain versions
    stand in for the kernels and one timed run a side is noise, so a
    budget, which the card's hot loop is held to, may fail here: then main
    stops with 1 at that gate, its figure over its budget). The exposition
    gate's scrape passes the port's ``validate_openmetrics``."""
    smoke = _load("telemetry")
    rc, out = smoke.main(["--out-dir", str(tmp_path), "--device", "cpu", "--repeats", "1"])
    assert set(out["report"]) == {"lasso_torch", "lasso_sparse", "lasso_distributed_1x4"}
    assert np.isfinite(out["telemetry_overhead_pct"])
    if rc != 0:
        assert (out["telemetry_overhead_pct"] > smoke.OVERHEAD_PCT
                or out["metrics_overhead_pct"] > smoke.METRICS_OVERHEAD_PCT)
    dev = torch.device("cpu")
    assert smoke.exposition_gate(str(tmp_path), dev) == 0
    from repro_torch.obs import validate_openmetrics

    assert not validate_openmetrics((tmp_path / "metrics.txt").read_text())
    assert np.isfinite(smoke.bridge_overhead_gate(dev, repeats=1))


def test_telemetry_split_on_cpu():
    """The telemetry gate's cost split: its rounds of pairs timed as the
    smoke's gate times them (one pair a round here), each solve's host work
    and waits, and the cProfile rows; the numbers finite and the host work
    and waits summing to no more than a wall would."""
    split = _load("split")
    rc, out = split.main(["--device", "cpu", "--pairs", "1", "--rounds", "2", "--no-profiler"])
    assert rc == 0
    assert len(out["rounds"]) == 2 and len(out["quartiles_pct"]) == 3
    assert all(np.isfinite(v) for v in out["rounds"] + out["quartiles_pct"])
    for side in ("off", "on"):
        assert out[f"host_{side}_ms"] > 0 and out[f"wait_{side}_ms"] >= 0


def test_chaos_matrix_on_cpu(tmp_path):
    """Every scenario heals on the CPU, rung 3 by the fallback to the plain
    route (on the card it raises instead)."""
    rc, results = _load("chaos").main(["--out", str(tmp_path / "chaos.json"), "--device", "cpu"])
    assert rc == 0 and all(results.values()) and len(results) == 6
    payload = json.loads((tmp_path / "chaos.json").read_text())
    assert payload["all_healed"] and payload["scenarios"] == results


def test_profile_capture_on_cpu(tmp_path):
    rc, out = _load("profile").main(["--out", str(tmp_path), "--p", "2000", "--m", "64",
                                     "--iters", "30", "--device", "cpu"])
    assert rc == 0 and out["iterations"] == 30
    summary = json.loads((tmp_path / "profile_summary.json").read_text())
    assert "profile/solve" in summary["span_table"]
    assert (tmp_path / "chrome_trace.json").exists()


@pytest.mark.parametrize("part", ["models", "configs", "training", "launch", "runtime",
                                  "compression", "parallel", "utils", "data"])
def test_lm_packages_import_neither_jax_nor_the_reference(part):
    """The LM serving slice's packages, and ``chip_smoke.py`` that drives
    them on the card."""
    files = sorted((REPO / "src" / "repro_torch" / part).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 1
    for f in files:
        tree = ast.parse(f.read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_serve_example_runs_on_cpu():
    """``examples/torch_serve_lm.py`` at its defaults (deepseek-7b reduced,
    4 prompts of 32, 24 tokens): its greedy tokens are the port's own
    prefill and serve steps on the same weights and prompts (seeds 0 and
    1, as ``launch.serve.run`` draws them)."""
    from repro_torch.launch.serve import synthetic_batch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import make_serve_step

    rc, out = _load("serve_lm").main(["--device", "cpu"])
    assert rc == 0 and out["card"] == "cpu" and out["tokens"].shape == (4, 24)
    cfg = get_config("deepseek_7b").reduced()
    params = M.init_params(0, cfg, "cpu")
    batch = synthetic_batch(cfg, 4, 32, torch.Generator().manual_seed(1))
    logits, cache = M.prefill(params, batch, cfg, max_seq=32 + 24 + 8)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = []
    serve = make_serve_step(cfg)
    for _ in range(24):
        tok, _, cache = serve(params, tok, cache)
        toks.append(tok)
    assert torch.equal(torch.cat(toks, 1), out["tokens"])


@pytest.mark.parametrize("arch", ["deepseek_7b", "mamba2_130m", "hymba_1_5b", "kimi_k2_1t_a32b",
                                  "seamless_m4t_medium", "internvl2_76b"])
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <a> --reduced --device
    cpu``: prefill, then greedy decode; its numbers and tokens."""
    from repro_torch.launch import serve

    rc, out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "12", "--tokens", "5"])
    assert rc == 0 and out["card"] == "cpu" and out["tokens"].shape == (2, 5)
    cfg = serve.get_config(arch).reduced()
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < cfg.vocab_size
    assert out["prefill_s"] > 0 and out["step_ms"] > 0 and out["params"] > 0


@pytest.mark.parametrize("fault", ["rope_table_bf16", "probs_f32", "norm_bf16", "ssm_state_bf16"])
def test_chip_smoke_planted_fault_runs_and_is_undone(fault):
    """``chip_smoke._planted``, the bf16-only faults that the card's serving
    checks plant to show what their limits catch: inside the ``with`` the
    port runs the faulty code (counted) and its bf16 logits move; after it
    the port's own functions are back, and its logits are the sound run's
    bit for bit (hymba at ``reduced()``: attention, SSM and norms)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_batch
    from repro_torch.models import attention, layers, ssm
    from repro_torch.models import model as M

    from repro_torch.configs import ARCH_IDS

    assert fault in chip_smoke.SERVE_FAULTS
    assert set(chip_smoke.SERVE_FAULTS_CAUGHT) <= set(chip_smoke.SERVE_FAULTS)
    assert set(chip_smoke.SERVE_BF16_ATOL) == set(chip_smoke.SERVE_CPU_BF16_ATOL) == set(ARCH_IDS)
    cfg = get_config("hymba_1_5b").reduced(dtype="bfloat16")
    params = M.init_params(0, cfg, "cpu")
    batch = synthetic_batch(cfg, 2, 12, torch.Generator().manual_seed(1))
    nxt = torch.randint(0, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(2))

    def decode():
        _, cache = M.prefill(params, batch, cfg, max_seq=24)
        out = []
        for t in range(3):
            lg, cache = M.decode_step(params, nxt[:, t:t + 1], cache, cfg)
            out.append(lg)
        return torch.cat(out, 1)

    def own():
        return (layers._rope_frequencies_on, attention._sdpa, M.rmsnorm, ssm.decode_ssm)

    originals = own()
    sound = decode()
    calls = [0]
    with chip_smoke._planted(torch, fault, calls):
        planted = decode()
    assert calls[0] > 0
    assert not torch.equal(planted, sound)
    assert all(a is b for a, b in zip(own(), originals))
    assert torch.equal(decode(), sound)



def test_dryrun_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch mamba2_130m --shape
    long_500k --device cpu --out DIR``: one production cell on 256 fake
    ranks (no card: the fake tensors' device is the CPU), its record in
    DIR under the reference's name, and ``--all`` without ``--arch`` or
    ``--shape`` refused."""
    rc = _load("dryrun").main(["--arch", "mamba2_130m", "--shape", "long_500k", "--device", "cpu",
                               "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2_130m_long_500k_16x16.json").read_text())
    assert rc == 0 and rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["device"] == "cpu"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["hbm_per_device_gb"] < 80
    with pytest.raises(SystemExit):
        _load("dryrun").main(["--device", "cpu", "--out", str(tmp_path)])


def test_dryrun_small_script_on_cpu(capsys):
    """``scripts/torch_debug_dryrun_small.py --device cpu`` at one config
    and kind: 8 fake ranks on (2, 4), exit 0, one OK line."""
    rc = _load("dryrun_small").main(["--device", "cpu", "--arch", "deepseek_7b",
                                     "--kinds", "decode"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK   deepseek_7b" in out and "0 failures" in out

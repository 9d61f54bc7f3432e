"""The step rules under batched lanes (``engine.solve_batched`` and
``path.fw_path_batched`` with ``FWConfig.step_rule`` away, pairwise, PARTAN
or lazy) on the CPU: each lane against the port's own sequential solve bit
for bit, and against the JAX reference's ``engine.solve_batched`` with the
same rule at the reference's own lane tolerance.

Against itself: lanes of three deltas on the reference's correlated
acceptance design (``tests/test_step_rules.py:42-61``, m = 300, p = 120),
each lane replaying a stream of its own (``LaneStreamSampler``), the lanes
freezing at their own steps. Each lane is the sequential ``solve`` on its
stream: alpha, the objective, iterations, n_dots, the vertex of every step
and the telemetry ring's records (with the objective on), bit for bit, on
'torch' (the plain ops) and 'sparse' (the kernels' plain versions on CPU
tensors). The lane direction tail's plain version is L one-lane plain
tails; a lazy hit in one lane skips that lane's row only; a rule's batched
path killed and resumed is the clean path, bit for bit; and a (1, 4) mesh
of 4 gloo ranks runs the away lanes bit for bit the single-device lanes.

Against the reference: the reference's lanes (its ``solve_batched``, a key
a lane, the reference vmapping ``rule_step``) and the port's lanes on the
reference's per-lane streams, drawn inside
``jax.threefry_partitionable(False)`` (ROADMAP.md Queue 3 R1) as
``tests/test_torch_rule_parity.py`` draws them: iterations, n_dots and
converged exact, alpha at the reference's lane tolerance (rtol 5e-3, atol
1e-2, ``tests/test_step_rules.py:285-296``). The steps compared stop short
of the acceptance design's first near-tie (``test_torch_rule_parity``'s
module docstring): 20 steps at an interior delta, where away, PARTAN and
lazy meet none, and pairwise's first 2 (its first pair step balances its
two atoms, a near-tie that f32 rounding decides, at step 3 of these lanes).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ENOracle as RefEN
from repro.core import FWConfig as RefConfig
from repro.core import LASSO as REF_LASSO
from repro.core import engine as ref_engine
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import (LASSO, LOGISTIC, ENOracle, FWConfig, LaneStreamSampler,
                              StreamSampler, engine, path, step_rule)
from repro_torch.kernels import step_tail as st
from repro_torch.obs import TelemetrySpec
from repro_torch.resilience import faults

REPO = Path(__file__).resolve().parents[1]
RULES = ["away", "pairwise", "partan", "lazy"]
KAPPA, SEED = 48, 42
DELTAS = [20.0, 5.0, 1.0]  # the lanes freeze at their own steps (tol 3e-2, patience 4)
LOG_DELTAS = [5.0, 2.0, 0.5]
MAX_ITERS = 150
# the reference comparison: an interior delta's lanes over 20 steps
REF_DELTAS = [2000.0, 1500.0, 1000.0]
REF_STEPS = {"away": 20, "pairwise": 2, "partan": 20, "lazy": 20}


@pytest.fixture(scope="module")
def corr():
    """The reference's pinned correlated design (``tests/test_step_rules.py:
    42-61``): AR(1) columns, rho 0.6, a strong 10-sparse signal."""
    rng = np.random.default_rng(11)
    m, p, rho = 300, 120, 0.6
    Z = rng.standard_normal((m, p)).astype(np.float32)
    X = np.empty_like(Z)
    X[:, 0] = Z[:, 0]
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + np.sqrt(1 - rho**2) * Z[:, j]
    coef = np.zeros(p, np.float32)
    coef[rng.choice(p, 10, replace=False)] = rng.standard_normal(10).astype(np.float32) * 50.0
    y = X @ coef + 1.0 * rng.standard_normal(m).astype(np.float32)
    return X.T.copy(), y.astype(np.float32)


def _bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _design(Xt, backend):
    X = torch.from_numpy(Xt)
    if backend != "sparse":
        return X
    ref_mat = RefMatrix.from_dense(Xt, block_size=64)
    return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                         ref_mat.p, ref_mat.m, ref_mat.block_size,
                                         ref_mat.nnz_max, "cpu")


def _oracle(name):
    return {"lasso": LASSO, "en": ENOracle(1.0), "logistic": LOGISTIC}[name]


def _draws(n_lanes, p, n_steps=MAX_ITERS, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, p, (n_steps, KAPPA))) for _ in range(n_lanes)]


def _cfg(rule, backend, **over):
    kw = dict(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=3e-2, patience=4,
              refresh_every=16, step_rule=rule, backend=backend,
              telemetry=TelemetrySpec(capacity=64, record_objective=True))
    kw.update(over)
    return FWConfig(**kw)


def _lanes_vs_sequential(oracle, design, y, cfg, deltas, draws, alpha0s=None):
    """Solve the lanes, then each lane's sequential solve on its stream;
    assert every fact bitwise. Returns the lane result."""
    seqs = [[] for _ in deltas]

    def on_step(state, active):
        for lane, a in enumerate(active):
            if a:
                seqs[lane].append(int(state.i_star[lane]))
            else:
                assert int(state.i_star[lane]) == -1

    sampler = LaneStreamSampler(draws)
    res, saved = engine.solve_batched(oracle, design, y, cfg, sampler, alpha0s, deltas,
                                      device="cpu", on_step=on_step)
    for lane, d in enumerate(deltas):
        seq = []
        one_sampler = StreamSampler(draws[lane])
        one = engine.solve(oracle, design, y, cfg, one_sampler,
                           None if alpha0s is None else alpha0s[lane], d, device="cpu",
                           on_step=lambda s: seq.append(int(s.i_star)))
        assert (one.iterations, one.n_dots) == (res.iterations[lane], res.n_dots[lane]), lane
        assert seq == seqs[lane], lane
        assert _bits(one.alpha, res.alpha[lane]), lane
        assert _bits(one.objective.reshape(()), res.objective[lane]), lane
        assert bool(one.converged) == bool(res.converged[lane])
        assert sampler.lanes[lane].position() == one_sampler.position(), lane
        if cfg.telemetry is not None:
            assert torch.equal(one.telemetry.buf, res.telemetry.buf[lane]), lane
            assert one.telemetry.cursor == res.telemetry.cursor[lane]
    return res, saved


@pytest.mark.parametrize("backend", ["torch", "sparse"])
@pytest.mark.parametrize("oracle_name", ["lasso", "en"])
@pytest.mark.parametrize("rule", RULES)
def test_rule_lanes_equal_sequential_solves(corr, rule, oracle_name, backend):
    """Three lanes under the rule, each bitwise its sequential solve (the
    ring's records with it), the lanes stopping at their own steps."""
    Xt, y = corr
    design = _design(Xt, backend)
    res, saved = _lanes_vs_sequential(_oracle(oracle_name), design, torch.from_numpy(y),
                                      _cfg(rule, backend), DELTAS, _draws(3, Xt.shape[0]))
    assert min(res.iterations) < max(res.iterations) and saved > 0


@pytest.mark.parametrize("rule", ["away", "lazy"])
def test_logistic_rule_lanes_equal_sequential_solves(corr, rule):
    """The logistic's rules under lanes (``DirRule._protocol_step`` a lane;
    the lazy rule's stacked peek and classic lane tail), each lane bitwise
    its sequential solve."""
    Xt, y = corr
    _lanes_vs_sequential(LOGISTIC, torch.from_numpy(Xt), torch.from_numpy(np.sign(y)),
                         _cfg(rule, "kernels"), LOG_DELTAS, _draws(3, Xt.shape[0]))


@pytest.mark.parametrize("rule", RULES)
def test_rule_lanes_with_patience_overshoot(corr, rule):
    """``fuse_steps = 4`` with patience 7: a rule runs the per-step loop on
    both sides (it does not fuse), so a lane stops where its sequential
    solve stops, with no chunk overshoot, and the warm-started fourth lane
    freezes early."""
    Xt, y = corr
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    cfg = _cfg(rule, "kernels", fuse_steps=4, patience=7, telemetry=None)
    draws = _draws(4, Xt.shape[0])
    warm = engine.solve(LASSO, X, yt, cfg, StreamSampler(draws[2]), None, DELTAS[1],
                        device="cpu")
    alpha0s = torch.zeros((4, Xt.shape[0]))
    alpha0s[3] = warm.alpha
    res, _ = _lanes_vs_sequential(LASSO, X, yt, cfg, DELTAS + [DELTAS[1]], draws, alpha0s)
    assert res.effective_fuse_steps == 1


def test_lazy_hit_in_one_lane_only(corr):
    """A step where one lane hits its cache and another misses: the hit
    lane's stream skips its row and the miss lane's draw takes its own, so
    each lane's stream position after the run is its sequential solve's
    (checked in ``_lanes_vs_sequential``) and the lanes' dot counts differ
    by the draws they skipped."""
    Xt, y = corr
    cfg = _cfg("lazy", "kernels", tol=0.0, patience=10**6, max_iters=60)
    split = []
    prev = [0, 0, 0]

    def count(state, active):
        inc = [n - p for n, p in zip(state.n_dots, prev)]
        prev[:] = state.n_dots
        hits = [d == cfg.lazy_cache + 1 for d in inc]
        if any(hits) and not all(hits):
            split.append(hits)

    draws = _draws(3, Xt.shape[0])
    res, _ = engine.solve_batched(LASSO, torch.from_numpy(Xt), torch.from_numpy(y), cfg,
                                  LaneStreamSampler(draws), None, DELTAS, device="cpu",
                                  on_step=count)
    assert split, "no step split the lanes' hits"
    _lanes_vs_sequential(LASSO, torch.from_numpy(Xt), torch.from_numpy(y), cfg, DELTAS, draws)


@pytest.mark.parametrize("en_l2", [None, 1.0])
@pytest.mark.parametrize("pairwise", [False, True])
def test_dir_tail_lanes_plain_is_one_lane_plain_tails(corr, pairwise, en_l2):
    """``dir_tail_lanes_plain`` is L one-lane ``dir_tail_plain`` calls on the
    lanes' operands, bit for bit (lane 0 refreshing, lane 1 frozen: its
    state kept, its vertices -1), and so are the kernel wrappers on CPU
    tensors and the GIVEN form on each lane's columns."""
    Xt, y = corr
    X = torch.from_numpy(Xt)
    p, m = X.shape
    L, n_buf = 3, 8
    g = torch.Generator().manual_seed(5)
    beta = torch.randn((L, p), generator=g) * (torch.rand((L, p), generator=g) < 0.1)
    buf = torch.stack([torch.nonzero(b).view(-1)[:n_buf] for b in beta])
    args = dict(scale=torch.rand(L, generator=g) + 0.5, maxabs=beta.abs().amax(1),
                step_inf=torch.rand(L, generator=g), stall=torch.tensor([0, 2, 1],
                                                                        dtype=torch.int32),
                resid=torch.randn((L, m), generator=g), s_quad=torch.rand(L, generator=g) * 100,
                f_lin=torch.rand(L, generator=g) * 50, y=torch.from_numpy(y), buf=buf,
                raw_b=torch.randn((L, n_buf), generator=g) * 10,
                i_f=torch.randint(0, p, (L,), generator=g), sel_f=torch.randn(L, generator=g),
                delta=torch.full((L,), 50.0))
    refresh = [True, False, False]
    lanes = torch.tensor([0, 2], dtype=torch.int32)
    cfg = FWConfig(delta=1.0)
    en = None if en_l2 is None else st.DirEN(en_l2, torch.rand(L, generator=g) * 10)
    vals = list(args.values())
    b_p, b_k, b_g = beta.clone(), beta.clone(), beta.clone()
    want = st.dir_tail_lanes_plain(X, b_p, *vals, refresh, lanes, pairwise, cfg, en)
    fn = st.dir_tail_lanes if en is None else st.dir_tail_en_lanes
    got = fn(X, b_k, *vals, refresh, lanes, pairwise, cfg, *(() if en is None else (en,)))
    zcols = torch.stack([st.dense_columns(X, st.dir_column_ids(i, b, p), m)
                         for i, b in zip(args["i_f"], buf)])
    gfn = st.dir_tail_lanes_given if en is None else st.dir_tail_en_lanes_given
    given = gfn(zcols, b_g, *vals, refresh, lanes, pairwise, cfg, *(() if en is None else (en,)))
    for out in (got, given):
        assert all(a is None or _bits(a, b) for a, b in zip(out, want))
    for lane in range(L):
        if lane == 1:
            assert _bits(b_p[lane], beta[lane]) and int(want.i_star[lane]) == -1
            assert _bits(want.resid[lane], args["resid"][lane])
            assert _bits(want.buf[lane], buf[lane]) and _bits(want.step_inf[lane],
                                                               args["step_inf"][lane])
            continue
        b1 = beta[lane].clone()
        one = st.dir_tail_plain(X, b1, *(args[k][lane].clone() for k in (
            "scale", "maxabs", "stall", "resid", "s_quad", "f_lin")), args["y"],
            buf[lane].clone(), args["raw_b"][lane].clone(), args["i_f"][lane].clone(),
            args["sel_f"][lane].clone(), args["delta"][lane].clone(), refresh[lane], pairwise,
            cfg, None if en is None else st.DirEN(en.l2, en.q_norm[lane].clone()))
        assert _bits(b_p[lane], b1)
        for f in one._fields:
            if getattr(one, f) is not None and f != "beta":
                assert _bits(getattr(want, f)[lane], getattr(one, f)), (lane, f)


@pytest.mark.parametrize("rule", RULES)
def test_rule_path_batched_kill_resume_bit_identical(tmp_path, corr, rule):
    """``fw_path_batched`` with a rule, killed at its second chunk and
    resumed from its checkpoint, is the clean path bit for bit (each grid
    point's rule state starts fresh, as in the reference)."""
    Xt, y = corr
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    deltas = np.geomspace(100.0, 2000.0, 6)
    cfg = _cfg(rule, "kernels", max_iters=60, telemetry=None, tol=1e-3)
    clean = path.fw_path_batched(X, yt, deltas, cfg, seed=5, lane_width=2, device="cpu")
    ck = str(tmp_path)
    with faults.inject(faults.FaultPlan([faults.FaultSpec(kind="kill", at=2)], seed=0)):
        with pytest.raises(faults.InjectedKill):
            path.fw_path_batched(X, yt, deltas, cfg, seed=5, lane_width=2, device="cpu",
                                 checkpoint_dir=ck)
    resumed = path.fw_path_batched(X, yt, deltas, cfg, seed=5, lane_width=2, device="cpu",
                                   checkpoint_dir=ck, resume_from=ck)
    for a, b in zip(clean.points, resumed.points):
        assert (a.iterations, a.n_dots, a.objective, a.l1) == (b.iterations, b.n_dots,
                                                              b.objective, b.l1)
        np.testing.assert_array_equal(a.alpha_nnz_idx, b.alpha_nnz_idx)
        np.testing.assert_array_equal(a.alpha_nnz_val, b.alpha_nnz_val)
    assert clean.saved_iters == resumed.saved_iters


# --------------------------------------------------------------------------
# against the reference's lanes
# --------------------------------------------------------------------------


def _ref_lane_streams(keys, n_steps, p):
    """Each reference lane's stream: its key split every step (hit or miss)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, p)

        return [np.asarray(jax.lax.scan(body, k, None, length=n_steps)[1]) for k in keys]


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("sparse", "sparse")])
@pytest.mark.parametrize("oracle_name", ["lasso", "en"])
@pytest.mark.parametrize("rule", RULES)
def test_rule_lanes_match_reference_lanes(corr, rule, oracle_name, backend, ref_backend):
    """The reference's ``solve_batched`` under the rule against the port's
    lanes on the reference's per-lane streams: iterations, n_dots and
    converged exact, alpha at rtol 5e-3, atol 1e-2."""
    Xt, y = corr
    n_steps = REF_STEPS[rule]
    kw = dict(delta=1.0, kappa=KAPPA, max_iters=n_steps, tol=1e-4, patience=20,
              step_rule=rule)
    ref_oracle = REF_LASSO if oracle_name == "lasso" else RefEN(1.0)
    p = Xt.shape[0]
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(SEED), len(REF_DELTAS))
        ref_design = (RefMatrix.from_dense(Xt, block_size=64) if backend == "sparse"
                      else jnp.asarray(Xt))
        ref, _ = ref_engine.solve_batched(
            ref_oracle, ref_design, jnp.asarray(y), RefConfig(backend=ref_backend, **kw), keys,
            jnp.zeros((len(REF_DELTAS), p), jnp.float32), jnp.asarray(REF_DELTAS, jnp.float32))
        streams = _ref_lane_streams(list(keys), n_steps, p)
    res, _ = engine.solve_batched(_oracle(oracle_name), _design(Xt, backend),
                                  torch.from_numpy(y), FWConfig(backend=backend, **kw),
                                  convert.lane_streams_from_reference(streams, "cpu"), None,
                                  REF_DELTAS, device="cpu")
    for lane in range(len(REF_DELTAS)):
        assert res.iterations[lane] == int(ref.iterations[lane]), lane
        assert res.n_dots[lane] == int(ref.n_dots[lane]), lane
        assert bool(res.converged[lane]) == bool(ref.converged[lane]), lane
        np.testing.assert_allclose(res.alpha[lane].numpy(), np.asarray(ref.alpha[lane]),
                                   rtol=5e-3, atol=1e-2, err_msg=f"lane {lane}")


# --------------------------------------------------------------------------
# the mesh: a (1, 4) mesh of 4 gloo ranks
# --------------------------------------------------------------------------


MESH_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp

    def run(rank, work):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method="file://" + os.path.join(work, "init"),
                                 world_size=4, rank=rank)
        from repro_torch import distributed as D
        from repro_torch.core import ENOracle, FWConfig, LASSO, LaneStreamSampler, engine
        from repro_torch.sparse.matrix import SparseBlockMatrix

        z = np.load(os.path.join(work, "in.npz"))
        Xt, y = torch.from_numpy(z["Xt"]), torch.from_numpy(z["y"])
        draws = [torch.from_numpy(z[f"s{lane}"]) for lane in range(3)]
        deltas = [20.0, 5.0, 1.0]
        mesh = D.fw_mesh(1, 4)
        out = {}
        for layout in ("dense", "sparse"):
            for name, oracle in (("lasso", LASSO), ("en", ENOracle(1.0))):
                cfg = FWConfig(delta=1.0, kappa=48, max_iters=150, tol=3e-2, patience=4,
                               refresh_every=16, step_rule="away",
                               backend="sparse" if layout == "sparse" else "kernels")
                design = SparseBlockMatrix.from_dense(Xt, block_size=32) if layout == "sparse" \\
                    else Xt
                op = (D.shard_sparse(design, y, mesh, device="cpu") if layout == "sparse"
                      else D.shard_dense(Xt, y, mesh, device="cpu"))
                got, _ = D.solve_batched(oracle, op, cfg, LaneStreamSampler(draws), None, deltas)
                if rank == 0:
                    one, _ = engine.solve_batched(oracle, design, y, cfg,
                                                  LaneStreamSampler(draws), None, deltas,
                                                  device="cpu")
                    out[f"{layout}-{name}"] = {
                        "alpha": bool(torch.equal(got.alpha.view(torch.int32),
                                                  one.alpha.view(torch.int32))),
                        "iterations": [got.iterations, one.iterations],
                        "n_dots": [got.n_dots, one.n_dots]}
        if rank == 0:
            with open(os.path.join(work, "out.json"), "w") as fh:
                json.dump(out, fh)
        tdist.barrier()
        tdist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4, join=True)
""")


def test_mesh_away_lanes_are_the_single_device_lanes(tmp_path, corr):
    """The away lanes on a (1, 4) mesh of 4 gloo ranks (the buffers' owned
    lane scores and the lane direction tail's GIVEN form, the columns
    completed over the ranks) are the single-device lanes bit for bit,
    dense and block-ELL, the lasso and the elastic-net."""
    Xt, y = corr
    draws = _draws(3, Xt.shape[0])
    np.savez(tmp_path / "in.npz", Xt=Xt, y=y, **{f"s{lane}": d.numpy()
                                                  for lane, d in enumerate(draws)})
    script = tmp_path / "mesh_script.py"
    script.write_text(MESH_SCRIPT)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": os.environ.get("HOME", "/tmp"), "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads((tmp_path / "out.json").read_text())
    assert len(out) == 4
    for case, facts in out.items():
        assert facts["alpha"], case
        assert facts["iterations"][0] == facts["iterations"][1], case
        assert facts["n_dots"][0] == facts["n_dots"][1], case


def test_rules_carry_their_lane_state():
    """``stack_states`` stacks each rule's state with a lane axis, and
    ``solve_batched`` runs every rule (no refusal)."""
    X = torch.randn(40, 30, generator=torch.Generator().manual_seed(0))
    y = torch.randn(30, generator=torch.Generator().manual_seed(1))
    for rule, shapes in (("away", [(2, 32)]), ("pairwise", [(2, 32)]),
                         ("partan", [(2, 40), (2, 30), (2,)]), ("lazy", [(2, 16), (2,)])):
        cfg = FWConfig(delta=1.0, kappa=8, max_iters=5, step_rule=rule)
        states = [engine.init_state(LASSO, X, y, None, cfg) for _ in range(2)]
        rule_state = engine.stack_states(states).rule
        leaves = [rule_state] if isinstance(rule_state, torch.Tensor) else list(rule_state)
        assert [tuple(t.shape) for t in leaves] == shapes, rule
        draws = [torch.randint(0, 40, (5, 8), generator=torch.Generator().manual_seed(lane))
                 for lane in range(2)]
        res, _ = engine.solve_batched(LASSO, X, y, cfg, LaneStreamSampler(draws), None,
                                      [1.0, 2.0], device="cpu")
        assert res.iterations == [5, 5]
    assert step_rule.get_rule(FWConfig(delta=1.0, step_rule="lazy")).peek_lanes

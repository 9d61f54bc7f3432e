"""The port's resilience layer (``repro_torch.resilience``) against the JAX
reference's (``repro.resilience``) on the CPU, in one process; the
classes mirror ``tests/test_resilience.py``'s.

Both packages get the same numpy problem and, for the solves, the same
index stream: the reference's own, drawn inside
``jax.threefry_partitionable(False)`` (ROADMAP.md Queue 3 R1) and replayed
through ``convert.stream_from_reference``. A fault plan with one seed
poisons the same element in both packages (the same ``numpy`` draws).

Tolerances, and why:
  * integer facts (iterations, n_dots, support, which rung healed, the
    counters) exact;
  * the port's guarded solve against its own unguarded one, and a killed
    and resumed path against the uninterrupted one: bit for bit (the same
    ops on the same stream; the retried chunk and the resumed points
    replay their own draws);
  * the port against the reference: the objective at rtol 1e-6 and alpha
    within 1e-6 of delta (the l1 radius bounds every coordinate), the
    goldens' tolerance for sums taken in another order; rung 1 rebuilds
    the co-state with a matvec in another order in each package, within
    the same bounds.
"""
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import fw_lasso as ref_fw_lasso
from repro.core.solver_config import FWConfig as RefConfig
from repro.obs import metrics as ref_metrics
from repro.resilience import faults as ref_faults
from repro.resilience import guards as ref_guards
from repro.resilience import validate as ref_validate
from repro.sparse import io as ref_sio
from repro.sparse.matrix import SparseBlockMatrix as RefSparse

from repro_torch import convert
from repro_torch.core import LASSO, FWConfig, TorchSampler, engine, path
from repro_torch.kernels import health, launch_counts
from repro_torch.obs import TelemetrySpec
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import checkpoint as path_ckpt
from repro_torch.resilience import faults, guards, validate
from repro_torch.sparse import SparseBlockMatrix
from repro_torch.sparse import io as sio

DELTA = 2.0


def _problem(seed=0, p=60, m=40, density=0.4):
    """tests/test_resilience.py's problem: a sparse Gaussian design (m, p)."""
    rng = np.random.default_rng(seed)
    Xd = rng.normal(size=(m, p)) * (rng.random(size=(m, p)) < density)
    y = rng.normal(size=m).astype(np.float32)
    return Xd.astype(np.float32), y


def _coo(Xd, y):
    r, c = np.nonzero(Xd)
    return sio.COOData(r.astype(np.int64), c.astype(np.int64), Xd[r, c].astype(np.float32), y,
                       Xd.shape)


def _ref_cfg(**kw):
    base = dict(max_iters=200, delta=DELTA, tol=0.0, patience=10**9)
    base.update(kw)
    return RefConfig(**base)


def _cfg(**kw):
    """The port's counterpart of ``_ref_cfg`` ('xla' is 'torch' here)."""
    base = dict(max_iters=200, delta=DELTA, tol=0.0, patience=10**9)
    base.update(kw)
    return FWConfig(**base)


def _stream(n_steps, p, kappa, seed=0):
    """The reference engine's uniform stream from PRNGKey(seed)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (kappa,), 0, p)

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=n_steps)
    return np.asarray(draws)


def _design(Xd, backend):
    """The port's design: dense ``Xt (p, m)`` or the block-ELL matrix."""
    Xt = np.ascontiguousarray(Xd.T)
    if backend == "sparse":
        return SparseBlockMatrix.from_dense(Xt, block_size=16)
    return torch.from_numpy(Xt)


def _ref_design(Xd, backend):
    Xt = np.ascontiguousarray(Xd.T)
    if backend == "sparse":
        return RefSparse.from_dense(Xt, block_size=16)
    return jnp.asarray(Xt)


# --------------------------------------------------------------------------
# Fault-injection harness
# --------------------------------------------------------------------------


class TestFaultHarness:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultSpec(kind="cosmic_ray")

    def test_no_plan_hooks_are_noops(self):
        data = b"abc123"
        assert faults.maybe_corrupt_bytes("s", data) is data
        faults.check_kill("path_point", 0)  # no raise
        faults.maybe_delay("dist_dispatch")
        assert faults.active_plan() is None
        state = engine.init_state(LASSO, torch.ones(4, 3), torch.ones(3))
        assert faults.maybe_corrupt_state(state) is state

    def test_one_shot_spec_fires_once(self):
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=-1)], seed=1)
        with faults.inject(plan):
            with pytest.raises(faults.InjectedKill):
                faults.check_kill("path_point", 0)
            faults.check_kill("path_point", 1)  # spec spent: no raise
        assert len(plan.fired("kill")) == 1

    def test_occurrence_index_targets_one_call(self):
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=2)], seed=1)
        with faults.inject(plan):
            faults.check_kill("path_point", 0)
            faults.check_kill("path_point", 1)
            with pytest.raises(faults.InjectedKill):
                faults.check_kill("path_point", 2)

    def test_site_filter(self):
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", site="path_chunk", at=-1)],
                                seed=1)
        with faults.inject(plan):
            faults.check_kill("path_point", 0)  # other site: no raise
            with pytest.raises(faults.InjectedKill):
                faults.check_kill("path_chunk", 0)

    def test_byte_corruption_matches_the_reference(self):
        """The same seed flips the same bytes in both packages, and again."""
        data = bytes(range(256)) * 8
        out = []
        for mod in (faults, faults, ref_faults):
            plan = mod.FaultPlan([mod.FaultSpec(kind="shard_corrupt")], seed=42)
            with mod.inject(plan):
                out.append(mod.maybe_corrupt_bytes("f.npz", data))
        assert out[0] == out[1] == out[2] and out[0] != data

    @pytest.mark.parametrize("kind", ["co_nan", "beta_nan"])
    def test_state_poison_matches_the_reference(self, kind):
        """One seed poisons the same element of the residual (co_nan) or of
        beta (beta_nan) in both packages; the port writes a new tensor and
        leaves the old state's untouched."""
        Xd, y = _problem(3)
        alpha0 = np.linspace(-0.1, 0.1, Xd.shape[1]).astype(np.float32)
        ref_state = ref_engine.init_state(ref_fw_lasso.LASSO, jnp.asarray(Xd.T), jnp.asarray(y),
                                          jax.random.PRNGKey(0), jnp.asarray(alpha0),
                                          _ref_cfg())
        state = engine.init_state(LASSO, torch.from_numpy(np.ascontiguousarray(Xd.T)),
                                  torch.from_numpy(y), torch.from_numpy(alpha0), _cfg())
        ref_plan = ref_faults.FaultPlan([ref_faults.FaultSpec(kind=kind, value=np.inf)], seed=11)
        plan = faults.FaultPlan([faults.FaultSpec(kind=kind, value=np.inf)], seed=11)
        with ref_faults.inject(ref_plan):
            ref_bad = ref_faults.maybe_corrupt_state(ref_state)
        with faults.inject(plan):
            bad = faults.maybe_corrupt_state(state)
        field = "co" if kind == "co_nan" else "beta"
        want = np.asarray(ref_bad.co.resid if field == "co" else ref_bad.beta)
        got = (bad.co.resid if field == "co" else bad.beta).numpy()
        np.testing.assert_array_equal(np.flatnonzero(~np.isfinite(got)),
                                      np.flatnonzero(~np.isfinite(want)))
        assert np.isinf(got).sum() == 1
        old = state.co.resid if field == "co" else state.beta
        assert bool(torch.isfinite(old).all())

    def test_injections_counted_in_registry(self):
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="delay", seconds=0.0)], seed=1)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            faults.maybe_delay("dist_dispatch")
        assert reg.get("fw_faults_injected").value(kind="delay", site="dist_dispatch") == 1.0

    def test_env_seed(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_SEED, "9")
        assert faults.FaultPlan([]).seed == 9 == ref_faults.FaultPlan([]).seed


# --------------------------------------------------------------------------
# Input validation
# --------------------------------------------------------------------------


class TestInputValidation:
    def test_dense_nan_raises_before_solve(self):
        Xd, y = _problem(1)
        Xt = torch.from_numpy(np.ascontiguousarray(Xd.T))
        Xt[2, 3] = float("nan")
        with pytest.raises(ValueError, match="non-finite values"):
            engine.solve(LASSO, Xt, torch.from_numpy(y), _cfg(max_iters=50, delta=1.0),
                          TorchSampler(0, "cpu"), device="cpu")

    def test_y_inf_raises_with_counts(self):
        Xd, y = _problem(1)
        yb = torch.from_numpy(y.copy())
        yb[0] = float("inf")
        with pytest.raises(ValueError, match=r"y: 0 NaN / 1 Inf"):
            engine.solve(LASSO, torch.from_numpy(np.ascontiguousarray(Xd.T)), yb,
                         _cfg(max_iters=50, delta=1.0), TorchSampler(0, "cpu"), device="cpu")

    def test_sparse_matrix_values_checked(self):
        Xd, y = _problem(2)
        mat = SparseBlockMatrix.from_dense(np.ascontiguousarray(Xd.T), block_size=16)
        values = mat.values.clone()
        values[0, 0, 0] = float("nan")
        bad = dataclasses.replace(mat, values=values)
        with pytest.raises(ValueError, match="X.values"):
            engine.solve(LASSO, bad, torch.from_numpy(y), _cfg(max_iters=50, backend="sparse"),
                         TorchSampler(0, "cpu"), device="cpu")

    def test_clean_inputs_pass_and_solve(self):
        Xd, y = _problem(3)
        res = engine.solve(LASSO, np.ascontiguousarray(Xd.T), y, _cfg(max_iters=50),
                           TorchSampler(0, "cpu"), device="cpu")
        assert np.isfinite(float(res.objective))

    def test_env_skip_disables_check(self, monkeypatch):
        monkeypatch.setenv(validate.ENV_SKIP, "1")
        assert not validate.validation_enabled()
        validate.validate_inputs(None, torch.tensor([float("nan"), 1.0]))  # no raise

    def test_message_is_the_reference(self):
        """The same bad operands raise the same text in both packages."""
        Xd, y = _problem(4)
        Xd[0, 0], Xd[1, 1], y[2] = np.nan, np.inf, -np.inf
        Xt = np.ascontiguousarray(Xd.T)
        with pytest.raises(ValueError) as got:
            validate.validate_inputs(torch.from_numpy(Xt), torch.from_numpy(y))
        with pytest.raises(ValueError) as want:
            ref_validate.validate_inputs(jnp.asarray(Xt), jnp.asarray(y))
        assert str(got.value) == str(want.value)
        assert "X: 1 NaN / 1 Inf, y: 0 NaN / 1 Inf" in str(got.value)

    def test_the_engine_runs_the_one_check(self):
        assert engine.validate_inputs is validate.validate_inputs

    def test_identity_cache_checks_an_operand_once(self, monkeypatch):
        """A path's points pass the same objects: the O(nnz) pass runs once
        per object. The cache holds weak references only."""
        seen = []
        real = validate._nonfinite
        monkeypatch.setattr(validate, "_nonfinite", lambda a: seen.append(a.shape) or real(a))
        monkeypatch.setattr(validate, "_RECENT", type(validate._RECENT)(maxlen=8))
        X, y = torch.ones(5, 3), torch.ones(3)
        validate.validate_inputs(X, y)
        validate.validate_inputs(X, y)
        assert len(seen) == 2
        validate.validate_inputs(X.clone(), y)  # a new object is checked
        assert len(seen) == 3
        del X  # the clone is gone too: only y is still alive
        assert [ref() is y for ref in validate._RECENT if ref() is not None] == [True]


# --------------------------------------------------------------------------
# Shard checksums + retry healing
# --------------------------------------------------------------------------


class TestShardChecksums:
    @pytest.fixture()
    def shard_dir(self, tmp_path):
        Xd, y = _problem(4, p=50, m=64)
        sio.write_shards(str(tmp_path), _coo(Xd, y), rows_per_shard=16)
        return str(tmp_path)

    def test_manifest_carries_checksums(self, shard_dir):
        mf = sio.read_manifest(shard_dir)
        assert set(mf["checksums"]) == set(mf["shards"])
        assert sio.verify_shards(shard_dir) == [] == ref_sio.verify_shards(shard_dir)

    def test_verify_flags_damaged_file(self, shard_dir):
        mf = sio.read_manifest(shard_dir)
        victim = os.path.join(shard_dir, mf["shards"][1])
        blob = bytearray(Path(victim).read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        Path(victim).write_bytes(bytes(blob))
        assert sio.verify_shards(shard_dir) == [mf["shards"][1]] == ref_sio.verify_shards(shard_dir)

    def test_transient_corruption_heals_with_retry(self, shard_dir):
        mf = sio.read_manifest(shard_dir)
        clean = sio.load_shards(shard_dir)
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=mf["shards"][0])],
                                seed=5)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            healed = sio.load_shards(shard_dir)
        assert plan.fired("shard_corrupt")
        np.testing.assert_array_equal(clean.vals, healed.vals)
        np.testing.assert_array_equal(clean.y, healed.y)
        assert reg.get("fw_shard_checksum_failures").value(shard=mf["shards"][0]) == 1.0
        assert reg.get("fw_shard_retries").value(shard=mf["shards"][0]) == 1.0

    def test_persistent_corruption_raises(self, shard_dir):
        mf = sio.read_manifest(shard_dir)
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=mf["shards"][0],
                                                  at=-1, count=10**6)], seed=5)
        with faults.inject(plan):
            with pytest.raises(sio.ShardIntegrityError, match="sha256"):
                sio.load_shards(shard_dir)
        assert len(plan.fired("shard_corrupt")) == sio.SHARD_READ_RETRIES + 1

    def test_legacy_manifest_without_checksums_loads(self, shard_dir):
        mf = sio.read_manifest(shard_dir)
        del mf["checksums"]
        Path(shard_dir, sio.MANIFEST_NAME).write_text(json.dumps(mf))
        assert sio.verify_shards(shard_dir) == []
        assert sio.load_shards(shard_dir).shape == (64, 50)

    def test_corruption_heals_in_the_matrix_assembly(self, shard_dir):
        """A flipped read during the device fill pass heals to the same
        arrays."""
        mf = sio.read_manifest(shard_dir)
        clean, y0 = sio.load_shards_as_matrix(shard_dir, block_size=16, device="cpu")
        # occurrence 1 of the shard's read: the fill pass's (pass 1 reads first)
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=mf["shards"][2],
                                                  at=1)], seed=3)
        with faults.inject(plan):
            healed, y1 = sio.load_shards_as_matrix(shard_dir, block_size=16, device="cpu")
        assert len(plan.fired("shard_corrupt")) == 1
        assert torch.equal(clean.values, healed.values) and torch.equal(clean.rows, healed.rows)
        assert torch.equal(y0, y1)


# --------------------------------------------------------------------------
# Watchdog + degradation ladder
# --------------------------------------------------------------------------


def _same_result(a, b):
    return (torch.equal(a.alpha, b.alpha) and a.iterations == b.iterations
            and a.n_dots == b.n_dots and torch.equal(a.objective, b.objective))


GUARD_CASES = [
    ("torch", 1, {}), ("torch", 8, {}), ("kernels", 1, {}), ("kernels", 8, {}),
    ("sparse", 8, {}), ("sparse", 1, dict(sparse_kernel=False)),
    ("kernels", 1, dict(step_rule="away")), ("kernels", 1, dict(step_rule="pairwise")),
    ("kernels", 1, dict(step_rule="partan")), ("sparse", 1, dict(step_rule="lazy")),
]


class TestGuardedSolve:
    @pytest.fixture(scope="class")
    def prob(self):
        return _problem(6)

    @pytest.mark.parametrize("backend,fuse,extra", GUARD_CASES)
    def test_no_fault_is_the_unguarded_solve_bit_for_bit(self, prob, backend, fuse, extra):
        Xd, y = prob
        X = _design(Xd, backend)
        cfg = _cfg(backend=backend, fuse_steps=fuse, kappa=10, **extra)
        ref = engine.solve(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
        reg = obs_metrics.MetricsRegistry()
        with obs_metrics.use_registry(reg):
            res = guards.solve_resilient(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
        assert _same_result(ref, res)
        n_checks = reg.get("fw_guard_checks").value(backend=backend)
        assert n_checks == -(-res.iterations // (guards.GuardSpec().chunk_steps
                                                  * res.effective_fuse_steps))
        assert reg.get("fw_guard_trips") is None

    @pytest.mark.parametrize("backend,fuse,extra", GUARD_CASES)
    def test_beta_nan_heals_at_rung_2_bit_for_bit(self, prob, backend, fuse, extra):
        """The poisoned chunk is discarded and run again from the snapshot on
        its own draws (the sampler put back): every rule's state, the
        fused chunk and the in-place tails included."""
        Xd, y = prob
        X = _design(Xd, backend)
        cfg = _cfg(backend=backend, fuse_steps=fuse, kappa=10, **extra)
        seen, seen_ref = [], []
        ref = engine.solve(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu",
                           on_step=lambda s: seen_ref.append(s.i_star.view(-1).clone()))
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            res = guards.solve_resilient(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu",
                                         on_step=lambda s: seen.append(s.i_star.view(-1).clone()))
        assert plan.fired("beta_nan")
        assert _same_result(ref, res)
        # on_step saw the kept turns only: the retried chunk's, not the poisoned one's
        assert torch.equal(torch.cat(seen), torch.cat(seen_ref))
        assert reg.get("fw_guard_trips").value(backend=backend, reason="nonfinite_beta") == 1.0
        assert reg.get("fw_guard_recoveries").series() == [
            ((("backend", backend), ("rung", "retry_chunk")), 1.0)]

    def test_telemetry_ring_is_the_unguarded_ring(self, prob):
        Xd, y = prob
        X = _design(Xd, "kernels")
        cfg = _cfg(backend="kernels", fuse_steps=8, kappa=10, telemetry=TelemetrySpec(capacity=256))
        ref = engine.solve(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
        plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
        with faults.inject(plan):
            res = guards.solve_resilient(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
        assert torch.equal(ref.telemetry.buf, res.telemetry.buf)
        assert ref.telemetry.cursor == res.telemetry.cursor == 200

    @pytest.mark.parametrize("backend,ref_backend,fuse", [
        ("torch", "xla", 1), ("torch", "xla", 8), ("sparse", "sparse", 8)])
    @pytest.mark.parametrize("kind", [None, "co_nan", "beta_nan"])
    def test_matches_the_reference_guard(self, prob, backend, ref_backend, fuse, kind):
        """On the reference's stream and with the same plan seed, the port's
        guard trips where the reference's does, heals at the same rung, and
        lands on its result."""
        Xd, y = prob
        rcfg = _ref_cfg(backend=ref_backend, fuse_steps=fuse)
        cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
        draws = _stream(rcfg.max_iters, Xd.shape[1], rcfg.kappa)
        specs = [] if kind is None else [dict(kind=kind, at=1)]
        ref_reg, reg = ref_metrics.MetricsRegistry(), obs_metrics.MetricsRegistry()
        ref_plan = ref_faults.FaultPlan([ref_faults.FaultSpec(**s) for s in specs], seed=7)
        with jax.threefry_partitionable(False), ref_metrics.use_registry(ref_reg), \
                ref_faults.inject(ref_plan):
            want = ref_guards.solve_resilient(ref_fw_lasso.LASSO, _ref_design(Xd, ref_backend),
                                              jnp.asarray(y), rcfg, jax.random.PRNGKey(0))
        plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs], seed=7)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            got = guards.solve_resilient(LASSO, _design(Xd, backend), y, cfg,
                                         convert.stream_from_reference(draws, "cpu"),
                                         device="cpu")
        assert plan.events == ref_plan.events
        assert (got.iterations, got.n_dots) == (int(want.iterations), int(want.n_dots))
        alpha = np.asarray(want.alpha)
        np.testing.assert_array_equal(np.flatnonzero(got.alpha.numpy()), np.flatnonzero(alpha))
        assert np.abs(got.alpha.numpy() - alpha).max() <= 1e-6 * DELTA
        np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-6)
        for name in ("fw_guard_checks", "fw_guard_trips", "fw_guard_recoveries"):
            fam, ref_fam = reg.get(name), ref_reg.get(name)
            assert (fam is None) == (ref_fam is None)
            if fam is not None:
                assert [v for _, v in fam.series()] == [v for _, v in ref_fam.series()]
                assert [dict(k)["backend"] for k, _ in fam.series()] == [backend] * len(
                    fam.series())

    def test_co_nan_heals_via_rebuild_on_every_backend(self, prob):
        Xd, y = prob
        for backend in ("torch", "kernels", "sparse"):
            X = _design(Xd, backend)
            cfg = _cfg(backend=backend, fuse_steps=8, kappa=10)
            ref = engine.solve(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
            reg = obs_metrics.MetricsRegistry()
            plan = faults.FaultPlan([faults.FaultSpec(kind="co_nan", at=1)], seed=7)
            with obs_metrics.use_registry(reg), faults.inject(plan):
                res = guards.solve_resilient(LASSO, X, y, cfg, TorchSampler(0, "cpu"),
                                             device="cpu")
            assert reg.get("fw_guard_trips").value(backend=backend, reason="nonfinite_co") == 1.0
            assert reg.get("fw_guard_recoveries").value(backend=backend, rung="rebuild_co") == 1.0
            np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=1e-6)

    def test_unrecoverable_fault_raises(self, prob):
        Xd, y = prob
        cfg = _cfg(backend="torch", fuse_steps=8, kappa=10)
        # poison every chunk: the retry sees a fresh fault each time and the
        # trip budget runs out
        plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=-1, count=10**6)], seed=7)
        reg = obs_metrics.MetricsRegistry()
        with obs_metrics.use_registry(reg), faults.inject(plan):
            with pytest.raises(guards.UnrecoverableFaultError, match="max_trips=3"):
                guards.solve_resilient(LASSO, _design(Xd, "torch"), y, cfg,
                                       TorchSampler(0, "cpu"), guard=guards.GuardSpec(max_trips=3),
                                       device="cpu")
        assert reg.get("fw_guard_unrecovered").value(backend="torch") == 1.0
        assert reg.get("fw_guard_trips").value(backend="torch", reason="nonfinite_beta") == 4.0

    def test_exhausted_ladder_raises(self, prob, monkeypatch):
        """'torch' has no rung below it: a retry that stays poisoned ends
        the run."""
        Xd, y = prob
        monkeypatch.setattr(guards, "_retry_chunk", _poisoned_retry)
        plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=0)], seed=7)
        with faults.inject(plan):
            with pytest.raises(guards.UnrecoverableFaultError, match="ladder exhausted"):
                guards.solve_resilient(LASSO, _design(Xd, "torch"), y,
                                       _cfg(backend="torch", kappa=10), TorchSampler(0, "cpu"),
                                       device="cpu")

    @pytest.mark.parametrize("backend,fallback", [("kernels", "torch"), ("sparse", "sparse")])
    def test_rung_3_falls_back_a_backend(self, prob, monkeypatch, backend, fallback):
        """With rung 2 made to fail (a test-only patch), the chunk runs again
        from the snapshot on the plain route, counted as backend_fallback,
        and the run goes on there: the rest of the solve is the plain
        route's from that chunk on."""
        Xd, y = prob
        X = _design(Xd, backend)
        cfg = _cfg(backend=backend, fuse_steps=8, kappa=10)
        monkeypatch.setattr(guards, "_retry_chunk", _poisoned_retry)
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            res = guards.solve_resilient(LASSO, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
        assert reg.get("fw_guard_recoveries").series() == [
            ((("backend", fallback), ("rung", "backend_fallback")), 1.0)]
        # later checks run on the degraded config
        assert reg.get("fw_guard_checks").value(backend=fallback) >= 1.0
        fb = guards.fallback_config(cfg)
        ref = engine.solve(LASSO, X, y, fb, TorchSampler(0, "cpu"), device="cpu")
        # the plain route is the kernels' plain versions on CPU tensors: the
        # same trajectory to rounding
        assert res.iterations == ref.iterations and res.n_dots == ref.n_dots
        np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=1e-6)

    def test_fallback_config_ladder(self):
        assert guards.fallback_config(_cfg(backend="torch")) is None
        fb = guards.fallback_config(_cfg(backend="kernels"))
        assert fb is not None and fb.backend == "torch"
        fb = guards.fallback_config(_cfg(backend="sparse"))
        assert fb.backend == "sparse" and fb.sparse_kernel is False
        assert guards.fallback_config(fb) is None
        assert ref_guards.fallback_config(_ref_cfg(backend="pallas")).backend == "xla"

    def test_distributed_backend_rejected(self, prob):
        Xd, y = prob
        with pytest.raises(ValueError, match="solve_resilient_sharded"):
            guards.solve_resilient(LASSO, _design(Xd, "torch"), y, _cfg(backend="distributed"),
                                   TorchSampler(0, "cpu"), device="cpu")
        # as the reference's, the mesh guard takes the classic rule with
        # telemetry off (tests/test_torch_distributed.py runs it on a mesh)
        with pytest.raises(ValueError, match="classic step rule with telemetry off"):
            guards.solve_resilient_sharded(LASSO, None, _cfg(step_rule="away"), None)

    def test_resilient_solve_fn_in_the_path(self, prob):
        """fw_path through the guard is fw_path, bit for bit."""
        Xd, y = prob
        X = _design(Xd, "kernels")
        cfg = _cfg(backend="kernels", fuse_steps=8, kappa=10, max_iters=100)
        deltas = np.geomspace(0.5, 3.0, 4)
        clean = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu")
        guarded = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu",
                               solve_fn=guards.resilient_solve_fn(guards.GuardSpec(chunk_steps=2)))
        assert _points_bitwise(clean, guarded)
        with pytest.raises(ValueError, match="on_step"):
            path.fw_path(X, y, deltas, cfg, device="cpu", on_step=lambda g, s: None,
                         solve_fn=guards.resilient_solve_fn())


def _poisoned_retry(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, turns=None):
    out = guards._advance(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, True, turns)
    return out._replace(beta=torch.full_like(out.beta, float("nan")))


class TestHealthFlags:
    """``kernels/health``'s plain version (the CPU path of its wrapper)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("where", ["clean", "beta0", "beta_last", "scale", "resid_mid",
                                       "s_quad", "f_lin"])
    @pytest.mark.parametrize("value", [float("nan"), float("inf"), float("-inf")])
    def test_flags(self, dtype, where, value):
        if where == "clean" and value != value:
            value = 0.0
        beta = torch.linspace(-1, 1, 37).to(dtype)
        scale = torch.tensor(0.5, dtype=dtype)
        resid, s_quad, f_lin = torch.randn(11).to(dtype), torch.tensor(3.0, dtype=dtype), \
            torch.tensor(1.0, dtype=dtype)
        target = {"beta0": (beta, 0), "beta_last": (beta, -1), "scale": (scale, ()),
                  "resid_mid": (resid, 5), "s_quad": (s_quad, ()), "f_lin": (f_lin, ())}
        if where in target:
            t, i = target[where]
            t[i] = value
        stall = torch.tensor(17, dtype=torch.int32)
        before = launch_counts()
        out = health.health_flags(beta, scale, [resid, s_quad, f_lin], stall)
        assert launch_counts() == before  # CPU tensors: the plain version
        beta_bad = where in ("beta0", "beta_last", "scale") and not np.isfinite(value)
        co_bad = where in ("resid_mid", "s_quad", "f_lin") and not np.isfinite(value)
        assert out.dtype == torch.int32
        assert out.tolist() == [int(not beta_bad), int(not co_bad), 17]

    def test_guard_reads_the_float_leaves(self):
        Xd, y = _problem(1)
        state = engine.init_state(LASSO, torch.from_numpy(np.ascontiguousarray(Xd.T)),
                                  torch.from_numpy(y), None, _cfg())
        assert guards.health_check(state, _cfg(backend="kernels")) == (1, 1, 0)
        bad = state._replace(co=state.co._replace(f_lin=torch.tensor(float("nan"))))
        assert guards.health_check(bad, _cfg()) == (1, 0, 0)


# --------------------------------------------------------------------------
# Path checkpoint / resume
# --------------------------------------------------------------------------


def _points_bitwise(a, b) -> bool:
    if len(a.points) != len(b.points):
        return False
    for pa, pb in zip(a.points, b.points):
        if not (
            np.array_equal(pa.alpha_nnz_idx, pb.alpha_nnz_idx)
            and np.array_equal(pa.alpha_nnz_val, pb.alpha_nnz_val)
            and pa.alpha_nnz_val.dtype == pb.alpha_nnz_val.dtype
            and pa.n_dots == pb.n_dots
            and pa.iterations == pb.iterations
            and pa.objective == pb.objective
            and pa.active == pb.active
            and (pa.gap == pb.gap or (np.isnan(pa.gap) and np.isnan(pb.gap)))
        ):
            return False
    return True


def _path_design(backend, dtype):
    Xd, y = _problem(8, p=70, m=48)
    X = _design(Xd, backend)
    X = X.astype(dtype) if backend == "sparse" else X.to(dtype)
    return X, torch.from_numpy(y).to(dtype)


class TestPathCheckpointResume:
    def test_pack_unpack_roundtrip_preserves_dtype(self):
        pts = [
            path.PathPoint(reg=0.5, objective=1.25, l1=0.5, active=2, iterations=10, n_dots=400,
                           seconds=0.1, alpha_nnz_idx=np.array([3, 17], np.int64),
                           alpha_nnz_val=np.array([0.25, -0.25], np.float32), gap=1e-3),
            path.PathPoint(reg=1.0, objective=1.0, l1=1.0, active=1, iterations=20, n_dots=800,
                           seconds=0.2, alpha_nnz_idx=np.array([5], np.int64),
                           alpha_nnz_val=np.array([1.0], np.float32), gap=float("nan")),
        ]
        out = path_ckpt.unpack_points(path_ckpt.pack_points(pts))
        assert len(out) == 2
        assert out[0].alpha_nnz_val.dtype == np.float32
        np.testing.assert_array_equal(out[0].alpha_nnz_val, pts[0].alpha_nnz_val)
        np.testing.assert_array_equal(out[1].alpha_nnz_idx, pts[1].alpha_nnz_idx)
        assert out[1].n_dots == 800 and np.isnan(out[1].gap)
        packed = path_ckpt.pack_points(pts)
        from repro.resilience import checkpoint as ref_ckpt

        want = ref_ckpt.pack_points(pts)
        assert sorted(packed) == sorted(want)
        for k in packed:
            np.testing.assert_array_equal(packed[k], want[k])
            assert packed[k].dtype == want[k].dtype

    @pytest.mark.parametrize("backend,dtype,fuse,kill_at", [
        ("torch", torch.float32, 4, 1), ("torch", torch.float32, 4, 4),
        ("kernels", torch.float32, 4, 3), ("sparse", torch.float32, 4, 3),
        ("torch", torch.bfloat16, 1, 2), ("sparse", torch.bfloat16, 4, 2)])
    def test_fw_path_kill_resume_bit_identical(self, tmp_path, backend, dtype, fuse, kill_at):
        X, y = _path_design(backend, dtype)
        deltas = np.geomspace(0.5, 3.0, 7)
        cfg = _cfg(max_iters=100, fuse_steps=fuse, backend=backend, kappa=10)
        clean = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu")
        ck = str(tmp_path)
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=kill_at)], seed=0)
        with faults.inject(plan):
            with pytest.raises(faults.InjectedKill):
                path.fw_path(X, y, deltas, cfg, seed=5, device="cpu", checkpoint_dir=ck)
        resumed = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu", checkpoint_dir=ck,
                               resume_from=ck)
        assert _points_bitwise(clean, resumed)
        assert (clean.total_dots, clean.total_iters) == (resumed.total_dots, resumed.total_iters)

    def test_resume_takes_the_checkpoint_seed(self, tmp_path):
        """The snapshot's seed stands in for the reference's key: a resume
        with another seed argument still finishes the original path."""
        X, y = _path_design("torch", torch.float32)
        deltas = np.geomspace(0.5, 3.0, 5)
        cfg = _cfg(max_iters=60, kappa=10)
        clean = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu")
        ck = str(tmp_path)
        with faults.inject(faults.FaultPlan([faults.FaultSpec(kind="kill", at=2)], seed=0)):
            with pytest.raises(faults.InjectedKill):
                path.fw_path(X, y, deltas, cfg, seed=5, device="cpu", checkpoint_dir=ck)
        resumed = path.fw_path(X, y, deltas, cfg, seed=99, device="cpu", resume_from=ck)
        assert _points_bitwise(clean, resumed)

    @pytest.mark.parametrize("backend,dtype", [("torch", torch.float32),
                                               ("kernels", torch.bfloat16),
                                               ("sparse", torch.float32)])
    def test_fw_path_batched_kill_resume_bit_identical(self, tmp_path, backend, dtype):
        X, y = _path_design(backend, dtype)
        deltas = np.geomspace(0.5, 3.0, 7)
        cfg = _cfg(max_iters=100, fuse_steps=4, backend=backend, kappa=10)
        clean = path.fw_path_batched(X, y, deltas, cfg, seed=5, lane_width=3, device="cpu")
        ck = str(tmp_path)
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=2)], seed=0)
        with faults.inject(plan):
            with pytest.raises(faults.InjectedKill):
                path.fw_path_batched(X, y, deltas, cfg, seed=5, lane_width=3, device="cpu",
                                     checkpoint_dir=ck)
        resumed = path.fw_path_batched(X, y, deltas, cfg, seed=5, lane_width=3, device="cpu",
                                       checkpoint_dir=ck, resume_from=ck)
        assert _points_bitwise(clean, resumed)
        assert clean.saved_iters == resumed.saved_iters
        assert (clean.total_dots, clean.total_iters) == (resumed.total_dots, resumed.total_iters)

    def test_bf16_carry_is_cast_back(self, tmp_path):
        """The manager widens a bf16 carry to f32 on disk; the resume casts
        it back to the design's dtype before the warm start."""
        X, y = _path_design("torch", torch.bfloat16)
        path.fw_path(X, y, [0.5, 1.0], _cfg(max_iters=30, kappa=10), device="cpu",
                     checkpoint_dir=str(tmp_path))
        _, _, carry, _, _ = path_ckpt.load_path_checkpoint(str(tmp_path))
        assert carry.dtype == torch.float32
        assert torch.equal(carry.to(torch.bfloat16).float(), carry)

    def test_resume_without_checkpoint_starts_fresh(self, tmp_path):
        X, y = _path_design("torch", torch.float32)
        deltas = np.geomspace(0.5, 3.0, 7)
        cfg = _cfg(max_iters=60, fuse_steps=4, kappa=10)
        clean = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu")
        res = path.fw_path(X, y, deltas, cfg, seed=5, device="cpu",
                           resume_from=str(tmp_path / "empty"))
        assert _points_bitwise(clean, res)

    def test_checkpoints_pruned_and_every(self, tmp_path):
        X, y = _path_design("torch", torch.float32)
        deltas = np.geomspace(0.5, 3.0, 7)
        cfg = _cfg(max_iters=60, fuse_steps=4, kappa=10)
        path.fw_path(X, y, deltas, cfg, seed=5, device="cpu", checkpoint_dir=str(tmp_path))
        kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert kept == ["step_0000000005", "step_0000000006", "step_0000000007"]
        every = tmp_path / "every"
        path.fw_path(X, y, deltas, cfg, seed=5, device="cpu", checkpoint_dir=str(every),
                     checkpoint_every=3)
        # points 3 and 6, and always the last
        assert sorted(os.listdir(every)) == ["step_0000000003", "step_0000000006",
                                             "step_0000000007"]

"""The port's kernel wrappers (``repro_torch.kernels``) against the JAX
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them, on the same numpy inputs.

On CPU tensors each wrapper runs its plain PyTorch version, so these tests
hold that version to the Pallas kernel; the CUDA kernels themselves are
held to the plain versions on the card by tests/test_torch_gpu.py and by
chip_smoke.py.

Tolerances, and why: f32 sums of m products taken in different orders
differ by rounding, a few ulps of the Cauchy-Schwarz scale ||x|| * ||v||
of each dot product, so those compare within RTOL_SUM of that scale.
Argmax results (index and value) are exact: the inputs have no near-ties
except the exact ones built in, which both must break the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st  # skips @given tests when hypothesis is missing

from repro.kernels import colstats as ref_colstats
from repro.kernels import fw_vertex as ref_fw_vertex
from repro.kernels import residual_update as ref_residual_update
from repro.kernels import sampled_scores as ref_sampled_scores

from repro_torch.kernels import colstats as cs
from repro_torch.kernels import fw_grad as fw
from repro_torch.kernels import launch_counts
from repro_torch.kernels import residual_update as ru

RTOL_SUM = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dt):
    """The same values as a jax array and a torch CPU tensor of dtype ``dt``
    (both round the f32 numpy values to nearest-even)."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def _f64(x):
    return np.asarray(jnp.asarray(x, jnp.float32) if isinstance(x, jax.Array) else x.float(),
                      np.float64)


def _tied_problem(p, m, seed):
    """Rows 5, 17 and 900 are equal and r = row 5, so they tie exactly
    for the largest |score|."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((p, m)).astype(np.float32)
    X[17] = X[5]
    X[900] = X[5]
    return X, X[5].copy()


@pytest.mark.parametrize("p,m,dt", [(300, 80, "f32"), (1000, 803, "f32"), (513, 256, "bf16")])
def test_colstats_matches_pallas(p, m, dt):
    rng = np.random.default_rng(p + m)
    Xj, Xt = _pair(rng.standard_normal((p, m)).astype(np.float32), dt)
    yj, yt = _pair(rng.standard_normal(m).astype(np.float32), dt)
    zty_r, zn2_r = ref_colstats(Xj, yj, interpret=True)
    zty, zn2 = cs.colstats(Xt, yt)
    assert zty.dtype == zn2.dtype == torch.float32 and zty.shape == (p,)
    x64 = _f64(Xt)
    scale = np.linalg.norm(x64, axis=1) * np.linalg.norm(_f64(yt))
    assert np.all(np.abs(_f64(zty) - _f64(zty_r)) <= RTOL_SUM * scale)
    np.testing.assert_allclose(_f64(zn2), _f64(zn2_r), rtol=RTOL_SUM)


@pytest.mark.parametrize("m,dt", [(80, "f32"), (803, "f32"), (256, "bf16")])
@pytest.mark.parametrize("bs", [1, 128])
def test_sampled_scores_match_pallas(m, dt, bs):
    """p = 1000 is not a multiple of 128, so the last 128-block is a masked
    tail; width-1 draws repeat indices."""
    p = 1000
    rng = np.random.default_rng(m + bs)
    Xj, Xt = _pair(rng.standard_normal((p, m)).astype(np.float32), dt)
    rj, rt = _pair(rng.standard_normal(m).astype(np.float32), dt)
    if bs == 1:
        blk = rng.integers(0, p, 120).astype(np.int32)
        blk[7] = blk[3]  # a duplicate draw
    else:
        blk = np.array([7, 2, 0], np.int32)  # block 7 holds rows 896..1023
    got = fw.sampled_scores(Xt, rt, torch.from_numpy(blk).long(), bs)
    want = ref_sampled_scores(Xj, rj, jnp.asarray(blk), block_size=bs, interpret=True)
    rows = np.asarray(blk)[:, None] * bs + np.arange(bs)
    rows = rows.reshape(-1)
    x64 = np.vstack([_f64(Xt), np.zeros((1024 - p, m))])
    scale = np.linalg.norm(x64[rows], axis=1) * np.linalg.norm(_f64(rt))
    assert np.all(np.abs(_f64(got) - _f64(want)) <= RTOL_SUM * scale + 1e-30)
    assert np.all(_f64(got)[rows >= p] == 0.0)


@pytest.mark.parametrize("m", [80, 803])
@pytest.mark.parametrize("bs,blk,want", [
    (1, [3, 17, 998, 5, 17, 42, 999, 900], 17),  # exact three-way tie: first drawn wins
    (128, [7, 0, 3], 900),  # the tie inside the masked tail block
    (128, [0, 7], 5),
    (1, None, None),  # 200 random draws, no tie
])
def test_fw_vertex_matches_pallas(m, bs, blk, want):
    p = 1000
    X, r = _tied_problem(p, m, seed=m)
    if blk is None:
        blk = np.random.default_rng(m).integers(0, p, 200)
        r = np.random.default_rng(m + 1).standard_normal(m).astype(np.float32)
    blk = np.asarray(blk, np.int32)
    i_r, g_r = ref_fw_vertex(jnp.asarray(X), jnp.asarray(r), jnp.asarray(blk), block_size=bs,
                             interpret=True, p_valid=p)
    i, g = fw.fw_vertex(torch.from_numpy(X), torch.from_numpy(r), torch.from_numpy(blk), bs,
                        p_valid=p)
    assert i.shape == () and i.dtype == torch.int64
    assert int(i) == int(i_r)
    if want is not None:
        assert int(i) == want
    scale = np.linalg.norm(X[int(i)]) * np.linalg.norm(r)
    assert abs(float(g) - float(g_r)) <= RTOL_SUM * scale


def test_vertex_argmax_masks_indices_past_p_valid():
    """A padded coordinate never wins, even with the largest |score|."""
    scores = torch.tensor([1.0, -2.0, 3.0, -9.0])
    i, g = fw.vertex_argmax(scores, torch.tensor([0, 1]), 2, p_valid=3)
    assert (int(i), float(g)) == (2, 3.0)


def _jnp_vertex(scores, blk, bs, p_valid):
    """The reference's argmax over sampled scores (``fw_vertex``'s tail,
    src/repro/kernels/fw_grad/ops.py:40-45): indices >= p_valid masked to
    -1, ``jnp.argmax`` (NaN largest, the first of equals)."""
    idx = (jnp.asarray(blk)[:, None] * bs + jnp.arange(bs)[None, :]).reshape(-1)
    mag = jnp.where(idx < p_valid, jnp.abs(jnp.asarray(scores)), -1.0)
    j = jnp.argmax(mag)
    return int(idx[j]), float(jnp.asarray(scores)[j])


def _same_vertex(scores, blk, bs, p_valid):
    i, g = fw.argmax_plain(torch.from_numpy(scores), torch.from_numpy(blk), bs, p_valid)
    i_r, g_r = _jnp_vertex(scores, blk, bs, p_valid)
    assert int(i) == i_r
    assert float(g) == g_r or (np.isnan(float(g)) and np.isnan(g_r))


@pytest.mark.parametrize("kind", ["ties", "nan", "nan only where masked", "all masked"])
@pytest.mark.parametrize("n,bs", [(1, 1), (7, 1), (300, 1), (64, 4), (2049, 1)])
def test_argmax_plain_matches_jnp_argmax(n, bs, kind):
    """argmax_plain, vertex_argmax's CPU path and the card's yardstick,
    against jnp.argmax on exact ties, NaN and fully masked inputs."""
    rng = np.random.default_rng(n * 10 + bs)
    scores = rng.choice(np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32), n)
    blk = rng.permutation(4 * (n // bs) + 3)[: n // bs].astype(np.int64)
    p_valid = int(blk.max()) * bs + bs - 2 if n > 1 else 0
    idx = (blk[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
    if kind == "nan":
        scores[rng.choice(n, max(1, n // 10))] = np.nan
    elif kind == "nan only where masked":
        scores[idx >= p_valid] = np.nan
    elif kind == "all masked":
        p_valid = 0
    _same_vertex(scores, blk, bs, p_valid)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0, float("nan")]),
                min_size=1, max_size=64),
       st.sampled_from([1, 2, 4]), st.integers(0, 300))
def test_argmax_plain_matches_jnp_argmax_property(values, bs, p_valid):
    scores = np.asarray(values, np.float32)
    scores = scores[: len(scores) // bs * bs] if len(scores) >= bs else np.resize(scores, bs)
    blk = np.random.default_rng(len(scores)).permutation(80)[: len(scores) // bs]
    _same_vertex(scores, blk.astype(np.int64), bs, p_valid)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [1, 31, 1025, 2047, 2048, 2049, 42_723, 4_272_256, 10**8])
def test_argmax_grid_covers_the_scores(n, sms):
    """Every block of the argmax's grid takes a multiple-of-4 share, none
    is empty, and the grid stays within two blocks an SM: 21 blocks at
    kappa = 42,723, 2 per SM at n = p."""
    blocks, chunk = fw.argmax_grid(n, sms)
    assert chunk % 4 == 0 and 1 <= blocks <= fw.ARGMAX_BLOCKS_PER_SM * sms
    assert (blocks - 1) * chunk < n <= blocks * chunk
    assert chunk <= max(4, fw.ARGMAX_THREADS * fw.ARGMAX_PER_THREAD) or blocks == 2 * sms
    if n == 42_723:
        assert blocks == 21
    if n >= 4_272_256:
        assert blocks == 2 * sms


@pytest.mark.parametrize("m,dt", [(803, "f32"), (4096, "f32"), (800, "bf16")])
def test_residual_update_matches_pallas(m, dt):
    rng = np.random.default_rng(m)
    vals = [rng.standard_normal(m).astype(np.float32) for _ in range(3)]
    (rj, rt), (yj, yt), (zj, zt) = (_pair(v, dt) for v in vals)
    lam, delta_t = np.float32(0.3), np.float32(-2.5)
    want = ref_residual_update(rj, yj, zj, jnp.asarray(lam), jnp.asarray(delta_t), interpret=True)
    got = ru.residual_update(rt, yt, zt, torch.tensor(lam), torch.tensor(delta_t))
    assert got.dtype == rt.dtype and got.shape == (m,)
    # f32: the same elementwise formula, up to 1 ulp of the terms; bf16:
    # both round the same f32 value to bf16, up to one bf16 ulp
    tol = 2**-7 if dt == "bf16" else 1e-6
    scale = np.abs(_f64(rt)) + np.abs(_f64(yt)) + abs(delta_t) * np.abs(_f64(zt))
    assert np.all(np.abs(_f64(got) - _f64(want)) <= tol * scale)


def test_cpu_tensors_run_the_plain_versions():
    before = launch_counts()
    X = torch.randn(50, 16)
    cs.colstats(X, X[0])
    fw.fw_vertex(X, X[1], torch.arange(5), 1)
    ru.residual_update(X[0], X[1], X[2], torch.tensor(0.5), torch.tensor(1.0))
    assert launch_counts() == before


def test_other_devices_raise_rather_than_fall_back():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises (here: tensors on the meta device)."""
    X = torch.empty(50, 16, device="meta")
    with pytest.raises(ValueError):
        cs.colstats(X, X[0])
    with pytest.raises(ValueError):
        fw.sampled_scores(X, X[0], torch.arange(3, device="meta"), 1)
    with pytest.raises(ValueError):
        ru.residual_update(X[0], X[1], X[2], torch.tensor(0.5, device="meta"),
                           torch.tensor(1.0, device="meta"))

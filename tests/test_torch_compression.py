"""Top-k gradient compression with error feedback (``repro_torch.compression``)
on the CPU: the port's versions of ``tests/test_compression.py``'s five
cases, and the transmitted values, masks and error state against the
reference's ``compress_decompress`` on the same gradients (the k-th
largest magnitude as the threshold, kept with ``>=``: ties at the
threshold all go, as there), exactly, over several rounds of error
feedback; ``wire_bytes_saved`` equal to the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import compress_decompress as ref_compress
from repro.compression import init_compression as ref_init
from repro.compression.topk import wire_bytes_saved as ref_wire_bytes

from repro_torch.compression import compress_decompress, init_compression, wire_bytes_saved


def _np_grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((32, 64)).astype(np.float32),
            "w2": rng.standard_normal((128,)).astype(np.float32)}


def _grads(seed=0):
    return {k: torch.from_numpy(v) for k, v in _np_grads(seed).items()}


class TestCompression:
    def test_sparsity(self):
        g = _grads()
        sparse, _ = compress_decompress(g, init_compression(g), ratio=0.05)
        for leaf in sparse.values():
            nnz = int((leaf != 0).sum())
            assert nnz <= max(int(0.05 * leaf.numel()), 16) + 1

    def test_error_feedback_conserves_mass(self):
        """sent + error == grad + prev_error exactly (per leaf)."""
        g = _grads(1)
        sparse, new_state = compress_decompress(g, init_compression(g), ratio=0.1)
        for k in g:
            np.testing.assert_allclose((sparse[k] + new_state.error[k]).numpy(), g[k].numpy(),
                                       rtol=1e-6, atol=1e-6)

    def test_error_drains_over_steps(self):
        g = _grads(2)
        state = init_compression(g)
        total_sent = {k: torch.zeros_like(v) for k, v in g.items()}
        for _ in range(60):
            sparse, state = compress_decompress(g, state, ratio=0.05)
            total_sent = {k: total_sent[k] + sparse[k] for k in g}
        err_norm = sum(float(torch.linalg.norm(e)) for e in state.error.values())
        g_norm = sum(float(torch.linalg.norm(x)) for x in g.values())
        # EF steady-state error is O(||g|| / ratio): bounded, not growing with the rounds
        assert err_norm <= g_norm / 0.05 * 1.5

    def test_topk_selects_largest(self):
        x = {"w": torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 0.0])}
        sparse, _ = compress_decompress(x, init_compression(x), ratio=0.34, min_k=2)
        w = sparse["w"].numpy()
        assert w[1] == -5.0 and w[3] == 3.0
        assert np.count_nonzero(w) == 2

    def test_compressed_sgd_still_converges(self):
        """Least-squares SGD with 10% compression + EF reaches the solution."""
        rng = np.random.default_rng(3)
        A = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
        x_true = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        b = A @ x_true

        def grad(x):
            return {"x": A.T @ (A @ x["x"] - b) / 64}

        x = {"x": torch.zeros(32)}
        state = init_compression(grad(x))
        for _ in range(2000):
            sparse, state = compress_decompress(grad(x), state, ratio=0.1, min_k=2)
            x = {"x": x["x"] - 0.2 * sparse["x"]}
        err = float(torch.linalg.norm(x["x"] - x_true) / torch.linalg.norm(x_true))
        assert err < 1e-3, err


@pytest.mark.parametrize("ratio,min_k", [(0.05, 16), (0.1, 2), (0.5, 16)])
def test_rounds_match_the_reference(ratio, min_k):
    """Five rounds of error feedback on changing gradients, a tie at the
    threshold among them: each round's sent values (so the masks) and the
    error state equal to the reference's."""
    state, ref_state = init_compression(_grads()), ref_init({k: jnp.asarray(v) for k, v in
                                                             _np_grads().items()})
    for r in range(5):
        g = _np_grads(10 + r)
        g["w2"][:8] = 1.5  # ties
        sparse, state = compress_decompress({k: torch.from_numpy(v) for k, v in g.items()},
                                            state, ratio=ratio, min_k=min_k)
        want, ref_state = ref_compress({k: jnp.asarray(v) for k, v in g.items()}, ref_state,
                                       ratio=ratio, min_k=min_k)
        for k in g:
            np.testing.assert_array_equal(sparse[k].numpy() != 0, np.asarray(want[k]) != 0)
            np.testing.assert_array_equal(sparse[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(state.error[k].numpy(), np.asarray(ref_state.error[k]))


def test_wire_bytes_match_the_reference():
    g = _np_grads()
    assert wire_bytes_saved({k: torch.from_numpy(v) for k, v in g.items()}, 0.05) == \
        ref_wire_bytes({k: jnp.asarray(v) for k, v in g.items()}, 0.05)

"""The port's sparse IO (``repro_torch.sparse.io``) against the JAX
reference's (``repro.sparse.io``) on the CPU; ``TestSvmlight``,
``TestSvmlightStreaming`` and ``TestShards`` mirror
``tests/test_sparse_io.py``'s, and ``TestAcrossPackages`` reads the files
each package writes in the other.

The two packages' readers and writers are the same numpy code, so the
files, the parsed triplets and the assembled block-ELL arrays are compared
bit for bit; text round trips at rtol 1e-6 (``%.9g`` keeps f32 exactly,
and the reference's own test uses 1e-6). The reference's
``TestFetchLibsvm`` waits for the benches (ROADMAP.md Queue 1 item 14):
nothing is fetched in the port.
"""
import numpy as np
import pytest
import torch

from repro.data.proxies import make_sparse_coo as ref_make_sparse_coo
from repro.sparse import io as ref_sio

from repro_torch.core import FWConfig, TorchSampler, fw_solve
from repro_torch.data.proxies import make_sparse_coo
from repro_torch.sparse import COOData, SparseBlockMatrix
from repro_torch.sparse import io as sio


def _coo(seed=0, m=57, p=301, density=0.03):
    rows, cols, vals, y, _ = make_sparse_coo(m, p, density, 10, seed=seed)
    return sio.COOData(rows, cols, vals, y, (m, p))


def _canon(d: COOData):
    order = np.lexsort((d.cols, d.rows))
    return d.rows[order], d.cols[order], d.vals[order]


def _ref_matrix(shard_dir, block_size):
    mat, y = ref_sio.load_shards_as_matrix(shard_dir, block_size=block_size)
    return np.asarray(mat.values), np.asarray(mat.rows), mat.nnz_max, np.asarray(y)


class TestSvmlight:
    @pytest.mark.parametrize("zero_based", [False, True])
    def test_roundtrip(self, tmp_path, zero_based):
        data = _coo()
        path = tmp_path / "t.svm"
        sio.save_svmlight(path, data, zero_based=zero_based)
        back = sio.load_svmlight(path, n_features=data.shape[1], zero_based=zero_based)
        assert back.shape == data.shape
        for a, b in zip(_canon(data), _canon(back)):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        np.testing.assert_allclose(back.y, data.y, rtol=1e-6)

    def test_auto_base_detection_one_based(self, tmp_path):
        path = tmp_path / "one.svm"
        path.write_text("1.5 1:2.0 7:3.0\n-0.5 2:1.0\n")
        back = sio.load_svmlight(path)
        assert back.shape == (2, 7)
        assert set(back.cols.tolist()) == {0, 1, 6}

    def test_comments_and_qid_ignored(self, tmp_path):
        path = tmp_path / "q.svm"
        path.write_text("# header\n2.0 qid:4 1:1.0 # trailing\n\n3.0 2:5.0\n")
        back = sio.load_svmlight(path)
        assert back.shape[0] == 2
        np.testing.assert_allclose(back.y, [2.0, 3.0])

    def test_n_features_too_small_raises(self, tmp_path):
        path = tmp_path / "s.svm"
        path.write_text("1.0 5:1.0\n")
        with pytest.raises(ValueError, match="n_features"):
            sio.load_svmlight(path, n_features=2)

    def test_svmlight_to_solver(self, tmp_path):
        """Text -> shards -> block-ELL on the device -> a sparse solve."""
        data = _coo(seed=5, m=40, p=260)
        path = tmp_path / "full.svm"
        sio.save_svmlight(path, data)
        sio.convert_svmlight_to_shards(path, tmp_path / "shards", rows_per_shard=16,
                                       n_features=260)
        mat, y = sio.load_shards_as_matrix(tmp_path / "shards", block_size=128, device="cpu")
        res = fw_solve(mat, y, FWConfig(delta=5.0, backend="sparse", kappa=32, max_iters=300,
                                        tol=1e-4),
                       TorchSampler(0, "cpu"), device="cpu")
        assert np.isfinite(float(res.objective))
        assert float(res.alpha.abs().sum()) <= 5.0 * (1 + 1e-5)


class TestSvmlightStreaming:
    def test_streaming_conversion_equals_in_memory(self, tmp_path):
        """convert_svmlight_to_shards == load_svmlight + write_shards."""
        data = _coo(seed=8)
        svm = tmp_path / "d.svm"
        sio.save_svmlight(svm, data)  # 1-based
        stream_dir, mem_dir = tmp_path / "stream", tmp_path / "mem"
        sio.convert_svmlight_to_shards(svm, stream_dir, rows_per_shard=11)
        sio.write_shards(mem_dir, sio.load_svmlight(svm, zero_based=False), rows_per_shard=11)
        a, b = sio.load_shards(stream_dir), sio.load_shards(mem_dir)
        assert a.shape == b.shape
        for x, w in zip(_canon(a), _canon(b)):
            np.testing.assert_array_equal(x, w)
        np.testing.assert_array_equal(a.y, b.y)
        mat_a, _ = sio.load_shards_as_matrix(stream_dir, block_size=64, device="cpu")
        mat_b, _ = sio.load_shards_as_matrix(mem_dir, block_size=64, device="cpu")
        assert torch.equal(mat_a.to_dense(), mat_b.to_dense())

    def test_streaming_n_features_and_empty_rows(self, tmp_path):
        svm = tmp_path / "e.svm"
        svm.write_text("1.0 3:2.0\n0.5\n-1.0 1:1.0 7:4.0\n")
        out = tmp_path / "out"
        sio.convert_svmlight_to_shards(svm, out, rows_per_shard=2, n_features=10)
        man = sio.read_manifest(out)
        assert man["m"] == 3 and man["p"] == 10 and len(man["shards"]) == 2
        back = sio.load_shards(out)
        np.testing.assert_allclose(back.y, [1.0, 0.5, -1.0])
        assert set(back.cols.tolist()) == {0, 2, 6}


class TestShards:
    def test_roundtrip_nondivisible_rows(self, tmp_path):
        data = _coo()
        sio.write_shards(tmp_path, data, rows_per_shard=13)  # 57 % 13 != 0
        man = sio.read_manifest(tmp_path)
        assert man["m"] == 57 and man["p"] == 301 and len(man["shards"]) == 5
        back = sio.load_shards(tmp_path)
        for a, b in zip(_canon(data), _canon(back)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back.y, data.y)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_streaming_assembly_equals_direct(self, tmp_path, dtype):
        """The device fill pass gives ``from_coo``'s arrays bit for bit (the
        slot order of a stable sort by feature)."""
        data = _coo(seed=3)
        sio.write_shards(tmp_path, data, rows_per_shard=10)
        mat_s, y_s = sio.load_shards_as_matrix(tmp_path, block_size=64, dtype=dtype,
                                               device="cpu")
        mat_d = SparseBlockMatrix.from_coo(data.rows, data.cols, data.vals, data.shape,
                                           block_size=64).astype(dtype)
        assert torch.equal(mat_s.values, mat_d.values) and torch.equal(mat_s.rows, mat_d.rows)
        assert (mat_s.p, mat_s.m, mat_s.nnz_max) == (mat_d.p, mat_d.m, mat_d.nnz_max)
        assert mat_s.values.dtype == dtype and y_s.dtype == torch.float32
        np.testing.assert_array_equal(y_s.numpy(), data.y)

    def test_padded_budget_and_tail(self, tmp_path):
        """A larger nnz budget pads each feature's slots; the feature axis is
        padded to whole blocks (301 -> 320 at block 64), as the reference."""
        data = _coo(seed=3)
        sio.write_shards(tmp_path, data, rows_per_shard=10)
        mat, _ = sio.load_shards_as_matrix(tmp_path, block_size=64, nnz_max=9, device="cpu")
        want = ref_sio.load_shards_as_matrix(tmp_path, block_size=64, nnz_max=9)[0]
        assert mat.values.shape == (5, 64, 9) == tuple(want.values.shape)
        np.testing.assert_array_equal(mat.values.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(mat.rows.numpy(), np.asarray(want.rows))

    def test_shard_iteration_is_bounded(self, tmp_path):
        data = _coo(seed=4)
        sio.write_shards(tmp_path, data, rows_per_shard=20)
        for chunk, off in sio.iter_shards(tmp_path):
            assert chunk.y.shape[0] <= 20
            if chunk.rows.size:
                assert chunk.rows.min() >= off
                assert chunk.rows.max() < off + 20

    def test_rows_window_reads_its_shards_only(self, tmp_path):
        data = _coo(seed=4)
        sio.write_shards(tmp_path, data, rows_per_shard=20)
        man = sio.read_manifest(tmp_path)
        for lo, hi in ((0, 57), (19, 21), (40, 41), (30, 30), (-5, 500)):
            assert sio.shards_for_rows(man, lo, hi) == ref_sio.shards_for_rows(man, lo, hi)
            got = [off for _, off in sio.iter_shards_for_rows(tmp_path, lo, hi)]
            want = [off for _, off in ref_sio.iter_shards_for_rows(str(tmp_path), lo, hi)]
            assert got == want

    def test_budget_too_small_raises(self, tmp_path):
        data = _coo(seed=6)
        sio.write_shards(tmp_path, data, rows_per_shard=30)
        with pytest.raises(ValueError, match="nnz budget"):
            sio.load_shards_as_matrix(tmp_path, block_size=64, nnz_max=1, device="cpu")

    def test_unknown_format_raises(self, tmp_path):
        (tmp_path / sio.MANIFEST_NAME).write_text('{"format": "bogus"}')
        with pytest.raises(ValueError, match="unknown shard format"):
            sio.read_manifest(tmp_path)

    def test_assembly_runs_on_the_card_unless_told(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA card: the default device is usable")
        sio.write_shards(tmp_path, _coo(seed=2), rows_per_shard=30)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sio.load_shards_as_matrix(tmp_path, block_size=64)


class TestAcrossPackages:
    @pytest.mark.parametrize("rows_per_shard", [7, 64])
    def test_reference_shards_load_in_the_port(self, tmp_path, rows_per_shard):
        rows, cols, vals, y, _ = ref_make_sparse_coo(61, 333, 0.05, 10, seed=9)
        data = ref_sio.COOData(rows, cols, vals, y, (61, 333))
        ref_sio.write_shards(str(tmp_path), data, rows_per_shard=rows_per_shard)
        values, rws, nnz_max, y_ref = _ref_matrix(str(tmp_path), 64)
        mat, y_got = sio.load_shards_as_matrix(tmp_path, block_size=64, device="cpu")
        assert mat.nnz_max == nnz_max
        np.testing.assert_array_equal(mat.values.numpy(), values)
        np.testing.assert_array_equal(mat.rows.numpy(), rws)
        np.testing.assert_array_equal(y_got.numpy(), y_ref)
        got, want = sio.load_shards(tmp_path), ref_sio.load_shards(str(tmp_path))
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a, b)

    def test_port_shards_load_in_the_reference(self, tmp_path):
        data = _coo(seed=11, m=70, p=280)
        sio.write_shards(tmp_path / "port", data, rows_per_shard=16)
        ref_sio.write_shards(str(tmp_path / "ref"), ref_sio.COOData(*data), rows_per_shard=16)
        # the same bytes: the manifests (sha256 included) and every shard
        assert (sio.read_manifest(tmp_path / "port")
                == ref_sio.read_manifest(str(tmp_path / "ref")))
        assert ref_sio.verify_shards(str(tmp_path / "port")) == []
        values, rws, nnz_max, _ = _ref_matrix(str(tmp_path / "port"), 32)
        mat, _ = sio.load_shards_as_matrix(tmp_path / "port", block_size=32, device="cpu")
        np.testing.assert_array_equal(mat.values.numpy(), values)
        np.testing.assert_array_equal(mat.rows.numpy(), rws)

    def test_svmlight_text_is_the_same_file(self, tmp_path):
        data = _coo(seed=12)
        sio.save_svmlight(tmp_path / "port.svm", data)
        ref_sio.save_svmlight(tmp_path / "ref.svm", ref_sio.COOData(*data))
        assert (tmp_path / "port.svm").read_bytes() == (tmp_path / "ref.svm").read_bytes()
        got = sio.load_svmlight(tmp_path / "ref.svm", n_features=301)
        want = ref_sio.load_svmlight(tmp_path / "port.svm", n_features=301)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a, b)
        sio.convert_svmlight_to_shards(tmp_path / "ref.svm", tmp_path / "a", rows_per_shard=9)
        ref_sio.convert_svmlight_to_shards(tmp_path / "port.svm", tmp_path / "b",
                                           rows_per_shard=9)
        assert sio.read_manifest(tmp_path / "a") == ref_sio.read_manifest(str(tmp_path / "b"))

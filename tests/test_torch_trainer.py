"""The port's trainer (``repro_torch.runtime``) on the CPU: the port's
versions of ``tests/test_checkpoint.py``'s ``TestCrashResume`` (train(10)
== train(5) + crash + resume(10), bit for bit; the loss falls over 30
steps) and ``TestElasticRemesh`` (a state saved by 4 gloo ranks, each
holding a shard, restored in one process), a checkpoint the reference's
trainer reads and continues from, and the monitor and history.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_latest
from repro_torch.configs import get_config
from repro_torch.data.lm_pipeline import batch_at_step
from repro_torch.runtime import StepMonitor, Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]


class TestCrashResume:
    @pytest.fixture()
    def setup(self, tmp_path):
        cfg = get_config("deepseek_7b").reduced(n_layers=2)

        def data_fn(step):
            return batch_at_step(cfg, step, batch=4, seq_len=32, seed=9)

        return cfg, data_fn, tmp_path

    def test_resume_equivalence(self, setup):
        """train(10) == train(5) + crash + resume(10): bitwise final params
        and optimizer state."""
        cfg, data_fn, tmp = setup

        def trainer(d):
            return Trainer(cfg, TrainerConfig(total_steps=10, checkpoint_every=5,
                                              checkpoint_dir=str(tmp / d),
                                              async_checkpoint=False), data_fn, device="cpu")

        t1 = trainer("a")
        p1, o1, _ = t1.run()
        t2 = trainer("b")
        with pytest.raises(RuntimeError, match="simulated crash"):
            t2.run(crash_at=7)  # crashes after the checkpoint at step 5
        t3 = trainer("b")
        p3, o3, step3 = t3.run()
        assert step3 == 10 and len(t3.history) == 5
        assert t3.history == t1.history[5:]
        for (n, a), (_, b) in zip(p1.named_parameters(), p3.named_parameters()):
            assert torch.equal(a, b), n
        assert int(o1.step) == int(o3.step) == 10
        for path, leaf in o1.inner.items():
            for a, b in zip(leaf, o3.inner[path]):
                assert torch.equal(a, b), path

    def test_loss_decreases(self, setup):
        cfg, data_fn, tmp = setup
        t = Trainer(cfg, TrainerConfig(total_steps=30, checkpoint_every=100,
                                       checkpoint_dir=str(tmp / "c"), base_lr=1e-3,
                                       async_checkpoint=False), data_fn, device="cpu")
        t.run()
        first = np.mean(t.history[:5])
        last = np.mean(t.history[-5:])
        assert last < first, (first, last)
        assert t.monitor.step == 30 and t.monitor.ewma > 0


def test_async_checkpoint_resumes_as_the_sync_one(tmp_path):
    """Async saves (the default) write the same checkpoint: a resumed run
    from the async trainer's directory ends where the synchronous run
    does, and the heartbeat names the last step."""
    cfg = get_config("mamba2_130m").reduced(n_layers=1)

    def data_fn(step):
        return batch_at_step(cfg, step, batch=2, seq_len=16, seed=1)

    def trainer(d, sync):
        return Trainer(cfg, TrainerConfig(total_steps=4, checkpoint_every=2,
                                          checkpoint_dir=str(tmp_path / d),
                                          async_checkpoint=not sync), data_fn, device="cpu")

    p1, _, _ = trainer("s", True).run()
    with pytest.raises(RuntimeError):
        trainer("a", False).run(crash_at=3)
    t = trainer("a", False)
    p2, _, step = t.run()
    assert step == 4 and len(t.history) == 2
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    beat = json.loads((tmp_path / "a" / "heartbeat.json").read_text())
    assert beat["step"] == 2
    assert isinstance(t.monitor, StepMonitor)


def test_the_reference_trainer_continues_from_the_port_checkpoint(tmp_path):
    """The port's checkpoint is in the reference's layout: the reference's
    trainer restores it (its template's leaves, stacked) and its params are
    the port's."""
    from repro.configs import get_config as ref_get_config
    from repro.runtime import Trainer as RefTrainer
    from repro.runtime import TrainerConfig as RefConfig

    cfg = get_config("deepseek_7b").reduced(n_layers=2)
    rcfg = ref_get_config("deepseek_7b").reduced(n_layers=2)

    def data_fn(step):
        return batch_at_step(cfg, step, batch=2, seq_len=16, seed=3)

    t = Trainer(cfg, TrainerConfig(total_steps=2, checkpoint_every=2,
                                   checkpoint_dir=str(tmp_path), async_checkpoint=False),
                data_fn, device="cpu")
    params, _, _ = t.run()
    ref = RefTrainer(rcfg, RefConfig(total_steps=2, checkpoint_dir=str(tmp_path),
                                     async_checkpoint=False), data_fn)
    rp, ro, step = ref.init_or_restore()
    assert step == 2 and int(ro.step) == 2
    np.testing.assert_array_equal(np.asarray(rp["layers"]["attn"]["wq"][1]),
                                  params.layers[1].attn.wq.detach().numpy())
    np.testing.assert_array_equal(np.asarray(rp["embed"]["tok"]),
                                  params.embed.tok.detach().numpy())


REMESH_SCRIPT = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp

    def run(rank, work):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method="file://" + os.path.join(work, "init"),
                                 world_size=4, rank=rank)
        from repro_torch.checkpoint import save_checkpoint
        # each rank holds 2 rows of w (a (4,) data mesh over its rows)
        w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        shard = w[2 * rank:2 * rank + 2].clone()
        parts = [torch.empty_like(shard) for _ in range(4)]
        tdist.all_gather(parts, shard)
        if rank == 0:  # the full logical array, as every checkpoint holds it
            save_checkpoint(os.path.join(work, "ckpt"), 3, {"params": {"w": torch.cat(parts)}})
        tdist.barrier()
        tdist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4, join=True)
""")


class TestElasticRemesh:
    def test_checkpoint_restores_across_device_counts(self, tmp_path):
        """Checkpoints are mesh-agnostic: saved by 4 ranks, restored in this
        single process."""
        script = tmp_path / "remesh.py"
        script.write_text(REMESH_SCRIPT)
        env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
               "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp"),
               "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
        proc = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                              text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        step, state = load_latest(tmp_path / "ckpt", {"params": {"w": torch.zeros((8, 8))}})
        assert step == 3
        np.testing.assert_array_equal(state["params"]["w"].numpy(),
                                      np.arange(64, dtype=np.float32).reshape(8, 8))

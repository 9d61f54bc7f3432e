"""Fault-tolerant training loop: checkpoint/restart, straggler monitor,
deterministic data order, crash-equivalent resume (the port of
``repro.runtime.trainer``).

The host-side driver around the train step. A checkpoint holds the
parameters and the optimizer's state in the reference's layout (a layer
stack's blocks stacked on a leading axis, leaves keyed by their paths in
the reference's tree), so a directory that either package writes reads in
the other. Each step's batch comes from ``data_fn(step)`` (numpy or
tensors) and is moved to the parameters' device.

A resumed run is bit for bit the run that never stopped where its step
is deterministic: the same parameters, state and batch give the same
update. On the card that asks for deterministic kernels
(``torch.use_deterministic_algorithms(True)``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts): backward ops
that accumulate with atomics otherwise add in another order each run.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, load_latest_raw
from repro_torch.core.engine import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.monitor import StepMonitor
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training import optimizers as opt_lib


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    microbatches: int = 1
    base_lr: float = 3e-4
    seed: int = 0
    log_every: int = 10


def param_tree(params) -> Dict[str, torch.Tensor]:
    """The parameters in the reference's layout: leaf path -> tensor, a
    layer stack's blocks stacked on a leading axis (on the host)."""
    leaves = opt_lib.named_leaves(params)
    out = {}
    for path, (names, stacked) in opt_lib.leaf_groups(params).items():
        ts = [leaves[n].detach().cpu() for n in names]
        out[path] = torch.stack(ts) if stacked else ts[0]
    return out


@torch.no_grad()
def load_state(params, opt_state: opt_lib.OptState, state: Dict[str, Dict[str, np.ndarray]]):
    """Copy a checkpoint's groups (``load_latest_raw``'s ``{"params": ...,
    "opt": ...}``) into the parameters and the optimizer's state, in place,
    each tensor keeping its dtype and device."""

    def put(dst, arr):
        src = torch.from_numpy(np.array(arr))  # contiguous, 0-d kept
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint shape {tuple(src.shape)} for a tensor of "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))

    leaves = opt_lib.named_leaves(params)
    flat = state["params"]
    for path, (names, stacked) in opt_lib.leaf_groups(params).items():
        arr = flat[path]
        for i, n in enumerate(names):
            put(leaves[n], arr[i] if stacked else arr)
    opt = state["opt"]
    put(opt_state.step, opt["step"])
    for path, leaf in opt_state.inner.items():
        for field, t in zip(leaf._fields, leaf):
            put(t, opt[f"inner/{path}/{field}"])


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        trainer_cfg: TrainerConfig,
        data_fn: Callable[[int], Dict],  # step -> batch (deterministic)
        device="cuda",
    ):
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.data_fn = data_fn
        self.device = resolve_device(device)
        self.train_step = make_train_step(
            model_cfg,
            microbatches=trainer_cfg.microbatches,
            base_lr=trainer_cfg.base_lr,
            total_steps=trainer_cfg.total_steps,
        )
        self.ckpt = CheckpointManager(
            trainer_cfg.checkpoint_dir,
            keep=trainer_cfg.keep_checkpoints,
            async_save=trainer_cfg.async_checkpoint,
        )
        Path(trainer_cfg.checkpoint_dir).mkdir(parents=True, exist_ok=True)
        self.monitor = StepMonitor(
            heartbeat_path=Path(trainer_cfg.checkpoint_dir) / "heartbeat.json"
        )
        self.history = []

    def init_or_restore(self):
        params, opt_state = init_train_state(self.cfg.seed, self.model_cfg, self.device)
        self.ckpt.wait()
        restored = load_latest_raw(self.cfg.checkpoint_dir)
        if restored is not None:
            step, state = restored
            load_state(params, opt_state, state)
            return params, opt_state, step
        return params, opt_state, 0

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in self.data_fn(step).items()}

    def run(self, crash_at: Optional[int] = None):
        """Train to total_steps; ``crash_at`` simulates a failure (tests)."""
        params, opt_state, start = self.init_or_restore()
        step = start
        while step < self.cfg.total_steps:
            if crash_at is not None and step >= crash_at:
                raise RuntimeError(f"simulated crash at step {step}")
            batch = self._batch(step)
            self.monitor.begin()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            self.monitor.end()
            step += 1
            self.history.append(loss)
            if step % self.cfg.checkpoint_every == 0 or step == self.cfg.total_steps:
                self.ckpt.save(step, {"params": param_tree(params), "opt": opt_state})
        self.ckpt.wait()
        return params, opt_state, step

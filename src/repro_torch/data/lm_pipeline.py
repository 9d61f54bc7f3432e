"""Deterministic synthetic LM data pipeline (the port of
``repro.data.lm_pipeline``, a copy in numpy: its batches are the
reference's bit for bit).

Seeded, step-addressable batches: batch(step) is a pure function of
(seed, step), so a restarted job consumes the exact same token stream —
the property the crash-equivalence test asserts. A background prefetch
thread hides host-side generation latency (straggler mitigation).

The synthetic stream is a mixture of Zipfian unigrams and deterministic
motifs so the loss actually decreases during the e2e example runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_at_step(
    cfg: ModelConfig, step: int, *, batch: int, seq_len: int, seed: int = 0
) -> Dict:
    rng = np.random.default_rng((seed, step))
    V = cfg.vocab_size
    # Zipf-ish unigram over a capped vocab + copy motif for learnable signal
    base = rng.zipf(1.3, size=(batch, seq_len + 1)).astype(np.int64)
    tokens = np.minimum(base, V - 1).astype(np.int32)
    # motif: second half repeats the first half (copy task)
    half = (seq_len + 1) // 2
    tokens[:, half : 2 * half] = tokens[:, :half]
    out = {"tokens": tokens}
    if cfg.n_prefix_embeds:
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_prefix_embeds, cfg.d_model)
        ).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal(
            (batch, seq_len, cfg.d_model)
        ).astype(np.float32)
    return out


class PrefetchingLoader:
    """Background-thread prefetch of step-addressable batches."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        batch: int,
        seq_len: int,
        seed: int = 0,
        prefetch: int = 2,
        start_step: int = 0,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            b = batch_at_step(
                self.cfg,
                self._step,
                batch=self.batch,
                seq_len=self.seq_len,
                seed=self.seed,
            )
            self._q.put((self._step, b))
            self._step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

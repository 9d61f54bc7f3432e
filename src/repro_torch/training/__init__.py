"""The train, serve and prefill steps and the optimizers (the port of
``repro.training``)."""
from repro_torch.training import optimizers
from repro_torch.training.train_step import (
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "optimizers",
    "init_train_state",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]

"""The serve and prefill step builders (the port of ``repro.training``'s
serving half; the train step, ``init_train_state`` and the optimizers come
with the training slice)."""
from repro_torch.training.train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]

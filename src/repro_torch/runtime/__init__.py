"""The training loop (the port of ``repro.runtime``)."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.obs.monitor import StepMonitor

__all__ = ["Trainer", "TrainerConfig", "StepMonitor"]

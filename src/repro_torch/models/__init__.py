"""The LM stack on PyTorch (the port of ``repro.models``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import attention, layers, model, moe, sharding, ssm

__all__ = ["ModelConfig", "attention", "layers", "model", "moe", "sharding", "ssm"]

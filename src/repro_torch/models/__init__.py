"""The LM stack on PyTorch (the port of ``repro.models``, less its
``sharding``: its logical-axis rules are a JAX mesh's, and on one card the
reference's constraints are no-ops)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import attention, layers, model, moe, ssm

__all__ = ["ModelConfig", "attention", "layers", "model", "moe", "ssm"]

"""The LM stack of the port: parameter specs, layers and the model (dense,
ssm and hybrid families; prefill and decode)."""

from repro_torch.models.lm import layers, model, params

__all__ = ["layers", "model", "params"]

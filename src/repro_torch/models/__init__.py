from repro_torch.models.api import Model, build_model, frontend_len
from repro_torch.models.convert import params_from_jax

__all__ = ["Model", "build_model", "frontend_len", "params_from_jax"]

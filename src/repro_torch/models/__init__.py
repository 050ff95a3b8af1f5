"""Model zoo of the port: the dense transformer and the hybrid
(attention + mamba) family behind one Model interface (the other
families arrive in later slices)."""

from repro_torch.models.api import Model, build_model
from repro_torch.models.convert import from_jax_params

__all__ = ["Model", "build_model", "from_jax_params"]

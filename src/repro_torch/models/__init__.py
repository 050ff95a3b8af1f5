"""Model zoo of the port: the transformer families (dense, moe, vlm) and
the hybrid (attention + mamba) family behind one Model interface (the
ssm and encdec families arrive in later slices)."""

from repro_torch.models.api import (
    InputSpec,
    Model,
    build_model,
    input_specs,
    make_batch,
)
from repro_torch.models.convert import from_jax_params

__all__ = ["Model", "build_model", "from_jax_params", "InputSpec",
           "input_specs", "make_batch"]

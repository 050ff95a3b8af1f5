"""Flash attention: the Hopper kernels (``csrc/flash_attention.cu``) behind
``ops.flash_attention`` and ``ops.flash_attention_bwd``, and their plain
versions in ``ref.py``."""

from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain,
    flash_attention_ref,
)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_plain",
           "flash_attention_ref", "flash_attention_bwd_plain"]

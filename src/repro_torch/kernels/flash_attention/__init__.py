"""Flash-attention forward: the Hopper kernel (``csrc/flash_attention.cu``)
behind ``ops.flash_attention`` and its plain oracle ``ref.py``."""

from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_ref"]

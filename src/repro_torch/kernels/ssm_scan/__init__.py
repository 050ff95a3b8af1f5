"""Mamba selective scan: the Hopper kernel (``csrc/ssm_scan.cu``) behind
``ops.ssm_scan`` and its plain oracle ``ref.py``."""

from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_plain
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_plain", "ssm_scan_ref"]

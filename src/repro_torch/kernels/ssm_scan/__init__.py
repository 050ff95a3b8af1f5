"""Mamba selective scan: the Hopper kernels (``csrc/ssm_scan.cu``) behind
``ops.ssm_scan`` and ``ops.ssm_scan_bwd`` (with a gradient:
``ops.SSMScan``) and their plain versions in ``ref.py``."""

from repro_torch.kernels.ssm_scan.ops import (
    SSMScan,
    ssm_scan,
    ssm_scan_bwd,
    ssm_scan_plain,
)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_plain, ssm_scan_ref

__all__ = ["SSMScan", "ssm_scan", "ssm_scan_bwd", "ssm_scan_plain",
           "ssm_scan_ref", "ssm_scan_bwd_plain"]

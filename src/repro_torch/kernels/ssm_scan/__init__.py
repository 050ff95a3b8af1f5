"""Mamba selective scan: the Hopper kernel (``csrc/ssm_scan.cu``) behind
``ops.ssm_scan`` (with a gradient: ``ops.SSMScan``) and its plain
oracle and backward in ``ref.py``."""

from repro_torch.kernels.ssm_scan.ops import SSMScan, ssm_scan, ssm_scan_plain
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_plain, ssm_scan_ref

__all__ = ["SSMScan", "ssm_scan", "ssm_scan_plain", "ssm_scan_ref",
           "ssm_scan_bwd_plain"]

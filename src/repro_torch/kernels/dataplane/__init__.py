"""Dataplane kernels: the mediation data-movement primitives as a
hand-written Hopper kernel (``csrc/bounce.cu``) with plain versions for
CPU tensors.

* ``bounce.py`` — ``bounce_copy`` / ``mediated_cost`` wrappers and the
  host-side ``kernel_cost_totals`` split.
* ``ops.py`` — ``pallas_dataplane`` auto/on/off resolution and delay
  calibration.
"""

from repro_torch.kernels.dataplane.bounce import (
    COST_COPIES,
    COST_ITERS,
    DEFAULT_CHUNK_ELEMS,
    NUM_COST_COLS,
    bounce_copy,
    kernel_cost_totals,
    mediated_cost,
    mediated_cost_plain,
)
from repro_torch.kernels.dataplane.ops import (
    kernel_calibrate,
    kernel_iters_for_ns,
    rescale_iters,
    use_pallas_dataplane,
)

__all__ = [
    "bounce_copy", "mediated_cost", "mediated_cost_plain",
    "kernel_cost_totals", "use_pallas_dataplane",
    "kernel_calibrate", "kernel_iters_for_ns", "rescale_iters",
    "DEFAULT_CHUNK_ELEMS", "COST_ITERS", "COST_COPIES", "NUM_COST_COLS",
]

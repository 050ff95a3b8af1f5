"""Model FLOPs served in the window (every request's prompt tokens, no
padding, and output tokens; cordbench/flops.py) over the window's
seconds and the H100's 989 TFLOP/s of bf16 products."""

from cordbench import flops
from cordbench.drivers.serve_waves import request_flops


def read(run):
    if not run["rows"]:
        return None
    return 100.0 * request_flops(run["m"], run["rows"]) \
        / (run["window_s"] * flops.BF16_FLOPS)

"""Model FLOPs of the window's training steps (6 per matrix weight a
token, attention under each layer's window, the scan; no recompute;
cordbench/flops.py) over the window's seconds and the H100's 989
TFLOP/s of bf16 products."""

from cordbench import flops
from cordbench.drivers.train_steps import step_flops


def read(run):
    if not run["steps"]:
        return None
    return 100.0 * run["steps"] * step_flops(run["m"], run["mix"]) \
        / (run["window_s"] * flops.BF16_FLOPS)

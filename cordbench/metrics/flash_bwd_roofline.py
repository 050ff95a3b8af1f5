"""The flash backward kernels' share of their roofline in the profiled
steps: the least time of one call a layer and rank under that layer's
window (cordbench/flops.py, bf16 products) over the device time of the
operations named flash_bwd."""

from cordbench import flops
from cordbench.reference.common import layer_windows


def read(run):
    prof = run.get("prof")
    if prof is None or not prof.kernels:
        return None
    m, mix = run["m"], run["mix"]
    a = m["attention"]
    hd = a["head_dim"] or m["d_model"] // a["num_heads"]
    b = mix["global_batch"] // mix["ranks"]
    least = 0.0
    for w in layer_windows(m):
        ops, nbytes = flops.flash_bwd(b, mix["seq_len"], a["num_heads"],
                                      a["num_kv_heads"], hd, window=w)
        least += flops.least_s(ops, nbytes, flops.BF16_FLOPS)
    least *= run["profiled_steps"] * mix["ranks"]
    device_s = prof.device_us(lambda n: "flash_bwd" in n) / 1e6
    return 100.0 * least / device_s if device_s > 0 else None

"""The selective scan backward kernel's share of its roofline in the
profiled steps: the least time of one call a layer and rank
(cordbench/flops.py, float32 work at 67 TFLOP/s) over the device time
of the operations named ssm_bwd."""

from cordbench import flops


def read(run):
    prof = run.get("prof")
    if prof is None or not prof.kernels:
        return None
    m, mix = run["m"], run["mix"]
    s = m["ssm"]
    b = mix["global_batch"] // mix["ranks"]
    ops, nbytes = flops.scan_bwd(b, mix["seq_len"], s["expand"] * m["d_model"],
                                 s["state_size"])
    least = run["profiled_steps"] * mix["ranks"] * m["num_layers"] \
        * flops.least_s(ops, nbytes, flops.F32_FLOPS)
    device_s = prof.device_us(lambda n: "ssm_bwd" in n) / 1e6
    return 100.0 * least / device_s if device_s > 0 else None

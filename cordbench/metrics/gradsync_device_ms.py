"""Device time of the gradient sync per step: the dataplane's bounce and
stall kernels in the profiled steps.  The ranks' forward and backward
run with no dataplane (`rank_grads` passes dp=None), so every such launch
in a step is the sync's psums."""


def read(run):
    prof = run.get("prof")
    if prof is None or not prof.kernels:
        return None
    us = prof.device_us(lambda n: "bounce_kernel" in n
                        or "stall_kernel" in n)
    return us / run["profiled_steps"] / 1e3 if us > 0 else None

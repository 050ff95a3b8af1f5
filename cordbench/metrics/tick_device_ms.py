"""Device time of the operations launched inside the profiled slice's
decode-tick spans, per tick."""


def read(run):
    prof = run.get("prof")
    if prof is None or not prof.kernels:
        return None
    us, ticks = prof.device_us_in("decode")
    return us / ticks / 1e3 if ticks and us > 0 else None

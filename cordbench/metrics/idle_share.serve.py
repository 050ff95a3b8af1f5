"""Share of the profiled serving slice in which no operation ran on the
device: 1 - the union of the device operations' intervals over the
slice."""


def read(run):
    prof = run.get("prof")
    if prof is None or not prof.kernels or prof.window_us() <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_us() / prof.window_us())

"""Share of the profiled training slice in which the device sat idle
while the host was in a rank's forward and backward: the idle gaps whose
innermost program span is `train.rank_grads` or lies inside one, over
the slice."""

from cordbench import program_spans


def read(run):
    prof = run.get("prof")
    idle = program_spans.idle_us_by(
        run, lambda names: "ranks" if "train.rank_grads" in names else None)
    if not idle or prof.window_us() <= 0:
        return None
    return 100.0 * idle["ranks"] / prof.window_us()

"""Idle device time while the host is in the engine's own steps, per
decode tick: the profiled slice's idle gaps whose innermost program span
is a scheduling round, an index upload, the paged gather or scatter,
sampling or emitting, over the `engine.tick` spans."""

from cordbench import program_spans

HOST = ("engine.admit", "engine.upload", "engine.kv_gather",
        "engine.kv_scatter", "engine.sample", "engine.emit")


def read(run):
    ticks = len(program_spans.named(run, "engine.tick"))
    idle = program_spans.idle_us_by(
        run, lambda names: "engine" if names and names[0] in HOST else None)
    if not ticks or not idle:
        return None
    return idle["engine"] / 1e3 / ticks

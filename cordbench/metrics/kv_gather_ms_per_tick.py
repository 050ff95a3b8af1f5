"""Device time of the paged tick's gather of the slots' blocks into a
dense view per decode tick: the `engine.kv_gather` program spans'
CUDA-event time over the `engine.tick` spans."""

from cordbench import program_spans


def read(run):
    ticks = len(program_spans.named(run, "engine.tick"))
    return program_spans.device_ms_per(run, "engine.kv_gather", ticks)

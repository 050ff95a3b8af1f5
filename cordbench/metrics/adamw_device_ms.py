"""Device time of AdamW per step, the global-norm clip included: the
`train.adamw` program spans' CUDA-event time over their number."""

from cordbench import program_spans


def read(run):
    steps = len(program_spans.named(run, "train.adamw"))
    return program_spans.device_ms_per(run, "train.adamw", steps)

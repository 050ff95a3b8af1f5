"""Device time of the MoE layer's expert-weight casts per layer call: the
`moe.cast` program spans' CUDA-event time over the number of layer calls
(the spans of leaf `wi`, one a call)."""

from cordbench import program_spans


def read(run):
    calls = sum(s.attrs.get("leaf") == "wi"
                for s in program_spans.named(run, "moe.cast"))
    return program_spans.device_ms_per(run, "moe.cast", calls)

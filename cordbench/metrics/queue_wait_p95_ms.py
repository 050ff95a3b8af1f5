"""95th percentile over the profiled slice's requests of their time in
the engine's queue: each request's `engine.queue` program spans (from
its entry or re-queue to its grant), summed, host clock."""

from cordbench import program_spans, stats


def read(run):
    waits: dict = {}
    for s in program_spans.named(run, "engine.queue"):
        waits[s.rid] = waits.get(s.rid, 0) + s.end_ns - s.start_ns
    if not waits:
        return None
    return stats.percentile([w / 1e6 for w in waits.values()], 95) or None

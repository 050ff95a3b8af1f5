"""Launches of the dataplane's bounce kernel per decode tick, from its
wrapper's launch counter at the edges of every decode span."""


def read(run):
    spans = run.get("spans")
    ticks = [] if spans is None else spans.of("decode")
    if not ticks:
        return None
    return sum(r["launches"]["bounce"] for r in ticks) / len(ticks)

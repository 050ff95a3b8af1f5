"""Share of the decode slots holding a request, over the window's ticks:
the engine's occupancy steps over (decode ticks x slots)."""


def read(run):
    spans = run.get("spans")
    ticks = len(spans.of("decode")) if spans is not None else 0
    if not ticks:
        return None
    return 100.0 * run["occupancy_steps"] / (ticks * run["max_batch"])

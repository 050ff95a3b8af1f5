"""Mean wall time of the engine's prefill calls, whole prompts and chunks,
each in a synchronised span, over the window."""


def read(run):
    spans = run.get("spans")
    rows = [] if spans is None else spans.of("prefill") + spans.of("chunk")
    if not rows:
        return None
    return 1e3 * sum(r["end"] - r["start"] for r in rows) / len(rows)

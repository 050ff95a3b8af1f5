"""The program's own spans, read after the window and put on the
profiler's clock.

The port records spans at its layer boundaries (`repro_torch.core.obs`:
the engine's queue wait and host steps, the MoE layer's weight casts,
each dataplane edge, a train step's ranks, gradient sync and AdamW) only
while a torch.profiler session records, so in a traced run they cover
the profiled slice.  A program span carries `perf_counter_ns` stamps;
the profiler's events carry microseconds on its own clock.  Each of the
harness's spans in the slice is known on both clocks (`run["spans"]` on
`perf_counter`, `run["prof"].spans` on the profiler's), so the offset
between the clocks is the median over those pairs of the difference of
their midpoints.

An idle device gap belongs to the innermost program span that holds its
middle: the host was there while the device waited.  `engine.queue`
overlaps the spans around it rather than nesting, so it holds no gap.

Where the program records no spans (an untraced run, or a program
without the recorder), every reader here finds nothing and returns None.
"""

from __future__ import annotations

import bisect
import statistics

OVERLAPPING = ("engine.queue",)
FIT_SLACK_US = 100.0


def clock_offset_us(run) -> float | None:
    """Profiler microseconds minus `perf_counter` microseconds, from the
    profiled slice's harness spans; None without a profiled slice."""
    spans, prof = run.get("spans"), run.get("prof")
    if spans is None or prof is None or not prof.spans:
        return None
    lo, hi = run.get("slice_rows", (0, len(prof.spans)))
    rows = spans.rows[lo:hi]
    if len(rows) != len(prof.spans) or any(
            r["kind"] != p[0] for r, p in zip(rows, prof.spans)):
        return None
    return statistics.median(
        (ps + pe) / 2 - (r["start"] + r["end"]) * 5e5
        for r, (_, ps, pe) in zip(rows, prof.spans))


def recorded(run) -> tuple[list, float] | None:
    """(the program spans that lie in ``run``'s profiled slice, the clock
    offset), or None where there are none."""
    try:
        from repro_torch.core.obs import recorded_spans
    except ImportError:
        return None
    off = clock_offset_us(run)
    if off is None:
        return None
    lo, hi = run["prof"].window
    lo, hi = lo - off - FIT_SLACK_US, hi - off + FIT_SLACK_US
    out = [s for s in recorded_spans() if s.end_ns is not None
           and lo <= s.start_ns / 1e3 and s.end_ns / 1e3 <= hi]
    return (out, off) if out else None


def named(run, name: str) -> list:
    """The slice's program spans called ``name``."""
    got = recorded(run)
    return [] if got is None else [s for s in got[0] if s.name == name]


def device_ms_per(run, name: str, per: int) -> float | None:
    """Device milliseconds of the spans called ``name`` over ``per``;
    None where any of them has no device time (on the CPU)."""
    ms = [s.device_ms for s in named(run, name)]
    if not ms or not per or any(m is None for m in ms):
        return None
    return sum(ms) / per


def idle_gaps(prof):
    """(start, end) profiler microseconds of each stretch of the slice in
    which no device operation ran."""
    lo, hi = prof.window
    end = lo
    for _, s, e in prof.kernels + [("(slice end)", hi, hi)]:
        if s > end and min(s, hi) > end:
            yield end, min(s, hi)
        end = max(end, e)


class Innermost:
    """The innermost program span holding a profiler time.  Spans nest
    properly on the host, so the spans holding ``t`` are the latest span
    begun by ``t`` and its ancestors."""

    def __init__(self, spans: list, off: float):
        nested = sorted((s for s in spans if s.name not in OVERLAPPING),
                        key=lambda s: s.start_ns)
        self.spans = nested
        self.starts = [s.start_ns / 1e3 + off for s in nested]
        self.by_id = {s.id: s for s in nested}
        self.off = off

    def lineage(self, t: float) -> list[str]:
        """Names of the spans holding ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s.end_ns / 1e3 + self.off < t:
            s = self.by_id.get(s.parent)
        names = []
        while s is not None:
            names.append(s.name)
            s = self.by_id.get(s.parent)
        return names


def idle_us_by(run, label) -> dict | None:
    """Idle device microseconds of the slice by ``label(lineage)`` of the
    gap's middle (gaps labelled None left out); None without device
    operations or program spans."""
    prof, got = run.get("prof"), recorded(run)
    if got is None or prof is None or not prof.kernels:
        return None
    where = Innermost(*got)
    out: dict = {}
    for a, b in idle_gaps(prof):
        key = label(where.lineage((a + b) / 2))
        if key is not None:
            out[key] = out.get(key, 0.0) + (b - a)
    return out

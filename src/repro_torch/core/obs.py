"""Per-tenant observability timelines, the port of ``repro.core.obs``:
the dataplane's state made inspectable over *time*, not just per step.

The mediation pipeline (core/mediation.py), the verbs runtime
(core/verbs.py) and the serving engine (serve/engine.py) account traffic
into per-tenant counter blocks, but ``dp.runtime_report`` /
``Engine.tenant_report`` are one flat view per step.  A
:class:`CounterTimeline` turns those flat views into an append-only
host-side time series:

* :meth:`CounterTimeline.snapshot` appends one sample: a per-tenant
  counter dict (``dp.runtime_report(state)``, ``Engine`` counters, or any
  ``{tenant: {counter: cumulative_value}}`` of plain numbers) plus
  optional run-wide *gauges* (active slots, queue depth).  Snapshots only
  **read** counters between steps, never inside a step, so results are
  bit-identical with the toggle on or off.  A counter block on the card
  handed to :meth:`CounterTimeline.snapshot_block` is copied to the host
  once, as a whole.
* :meth:`CounterTimeline.rates` derives per-window series from
  consecutive samples: ``ops_s`` / ``bytes_s`` / ``chunks_s`` (deltas
  over wall time), ``throttled_pct`` / ``stalls_pct`` / ``denied_pct``
  (share of the window's ops), and the ``cq_depth`` high-water level.
* :meth:`CounterTimeline.save` writes the schema-versioned JSON run
  artifact (``runs/<name>_timeline.json``, schema ``cord-timeline/v2``,
  the same document ``repro`` writes, so an artifact of either package
  loads and validates in the other) and :meth:`CounterTimeline.panel`
  renders per-tenant ASCII sparkline panels for the console.
* :meth:`CounterTimeline.record_event` appends control-plane *events*
  (watcher triggers, elastic remeshes) to the artifact's ``events`` list
  (schema v2; v1 artifacts without events still load), and the optional
  ``sink=`` path streams every snapshot/event to a JSONL file as the run
  progresses, with optional byte rotation.
* :class:`ThresholdWatcher` is the trigger half of the elastic control
  loop: it watches the per-window rate series against thresholds with
  hysteresis (sustained-for-N-windows, cooldown) and emits trigger
  events that ``runtime/elastic.py`` turns into a remesh or a slot
  budget move.

Everything here is host-side Python + numpy on host floats: no tensor
reaches the rate math or the watchers.  Counter *names* come from
core/telemetry.py so the timeline columns can never drift from the
counter-block layout.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Sequence

import numpy as np

from repro_torch.core import telemetry as tl

# Artifact schema identifier.  Bump the version when the document layout
# changes; validate_timeline() refuses unknown schemas but accepts every
# version listed in TIMELINE_SCHEMAS (v1 = v2 without the events list).
TIMELINE_SCHEMA_V1 = "cord-timeline/v1"
TIMELINE_SCHEMA = "cord-timeline/v2"
TIMELINE_SCHEMAS = (TIMELINE_SCHEMA_V1, TIMELINE_SCHEMA)

# Derived per-window rate series (docs/observability.md for semantics).
# retrans_s/timeouts_s/srq_grants_s are the transport's fault-visibility
# series (docs/transport.md); cqe_err_pct is error CQEs as a share of the
# window's completions.  Older artifacts list fewer fields —
# validate_timeline checks a document against its OWN rate_fields list.
RATE_FIELDS = ("ops_s", "bytes_s", "chunks_s", "throttled_pct",
               "stalls_pct", "denied_pct", "cq_depth",
               "retrans_s", "timeouts_s", "srq_grants_s", "cqe_err_pct",
               "preempt_s", "restore_s")

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 48) -> str:
    """Render a numeric series as a unicode block sparkline.

    Series longer than ``width`` are bucket-averaged down; flat series
    render as a mid-height line so "constant" is distinguishable from
    "empty" (which renders as '')."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        # bucket-mean downsample to exactly `width` cells
        edges = np.linspace(0, len(vals), width + 1)
        vals = [float(np.mean(vals[int(edges[i]):max(int(edges[i + 1]),
                                                     int(edges[i]) + 1)]))
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0 or not math.isfinite(span):
        # flat series: baseline if it sits at zero, mid-height otherwise
        return _SPARK_BLOCKS[0 if hi == 0 else 3] * len(vals)
    idx = [min(int((v - lo) / span * (len(_SPARK_BLOCKS) - 1e-9)),
               len(_SPARK_BLOCKS) - 1) for v in vals]
    return "".join(_SPARK_BLOCKS[i] for i in idx)


class CounterTimeline:
    """Append-only per-tenant counter time series with derived rates.

    Samples carry *cumulative* counters (the counter-block convention:
    every column except ``cq_depth`` is monotone non-decreasing); rates
    are derived between consecutive samples at report/save time, so
    snapshotting stays O(tenants × counters) per step with no math on
    the hot path."""

    def __init__(self, source: str = "run",
                 counter_names: tuple[str, ...] = tl.COUNTER_NAMES,
                 sink: str | None = None, rotate_bytes: int = 0):
        if rotate_bytes and sink is None:
            raise ValueError("rotate_bytes needs a sink path to rotate")
        if rotate_bytes < 0:
            raise ValueError(f"rotate_bytes must be >= 0, got {rotate_bytes}")
        self.source = source
        self.counter_names = tuple(counter_names)
        self.samples: list[dict] = []
        self.events: list[dict] = []
        self._tenants: list[str] = []      # first-seen order
        self._gauge_names: list[str] = []
        self._sink_path = sink
        self._sink = None
        self._sink_header = False          # header written for this segment
        self.rotate_bytes = int(rotate_bytes)
        self.rotations = 0                 # completed segments (path.1..N)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def snapshot(self, step: int, report: dict, *, gauges: dict | None = None,
                 t: float | None = None) -> None:
        """Append one sample.

        ``report`` is ``{tenant: {counter: cumulative_value}}`` — exactly
        what ``dp.runtime_report(state)`` returns; missing counters read
        as 0.  ``gauges`` are run-wide instantaneous levels (e.g. active
        decode slots).  ``t`` defaults to ``time.perf_counter()``; pass
        explicit stamps for deterministic artifacts/tests."""
        tenants = {}
        for name, ctrs in report.items():
            if name not in self._tenants:
                self._tenants.append(name)
            tenants[name] = {k: float(ctrs.get(k, 0.0))
                             for k in self.counter_names}
        g = {k: float(v) for k, v in (gauges or {}).items()}
        for k in g:
            if k not in self._gauge_names:
                self._gauge_names.append(k)
        sample = {
            "step": int(step),
            "t": float(t if t is not None else time.perf_counter()),
            "tenants": tenants,
            "gauges": g,
        }
        self.samples.append(sample)
        self._sink_write({"sample": sample})

    def snapshot_block(self, step: int, ctrs, tenants: tuple[str, ...], *,
                       gauges: dict | None = None, t: float | None = None
                       ) -> None:
        """Counter-block form: a ``(len(tenants), NUM_COUNTERS)`` array or
        tensor in telemetry column order (``tenant_counters_init``
        layout).  A tensor is copied to the host once, whole
        (``tenant_counters_report``)."""
        self.snapshot(step, tl.tenant_counters_report(ctrs, tenants),
                      gauges=gauges, t=t)

    def record_event(self, kind: str, step: int, *, tenant: str | None = None,
                     t: float | None = None, detail: dict | None = None
                     ) -> dict:
        """Append a control-plane event (watcher ``trigger``, elastic
        ``remesh``, ...) to the artifact's ``events`` list (schema v2) and
        the JSONL sink.  Events carry their own step/time stamps — they
        happen *between* snapshots, not on the sample axis."""
        ev = {"kind": str(kind), "step": int(step),
              "t": float(t if t is not None else time.perf_counter()),
              "tenant": tenant, "detail": dict(detail or {})}
        self.events.append(ev)
        self._sink_write({"event": ev})
        return ev

    # ------------------------------------------------------------------
    # streaming JSONL sink
    # ------------------------------------------------------------------
    def _sink_write(self, obj: dict) -> None:
        if self._sink_path is None:
            return
        if self._sink is None:
            d = os.path.dirname(self._sink_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._sink = open(self._sink_path, "a")
            if not self._sink_header:
                # one header line per run's stream: re-running with the
                # same sink path appends a NEW stream after the old one,
                # and read_jsonl treats each header as a stream restart —
                # two runs never merge into one timeline with bogus
                # cross-run windows (docs/observability.md).  The flag
                # makes reopening after close() header-free: a late event
                # (recorded during engine shutdown, after the final
                # flush) continues the SAME stream instead of starting a
                # one-event "run" that orphans every earlier sample.
                self._sink.write(json.dumps(
                    {"schema": TIMELINE_SCHEMA, "source": self.source,
                     "counters": list(self.counter_names)}) + "\n")
                self._sink_header = True
        self._sink.write(json.dumps(obj) + "\n")
        self._sink.flush()
        if self.rotate_bytes and self._sink.tell() >= self.rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Seal the current sink segment as ``<path>.<k>`` (k counting up
        from 1, oldest first) and arm a fresh segment — the next write
        opens ``<path>`` anew with its own header line, so every sealed
        segment is independently readable by :meth:`read_jsonl` while
        :meth:`read_rotated` stitches the whole run back together."""
        self._sink.close()
        self._sink = None
        self.rotations += 1
        os.replace(self._sink_path, f"{self._sink_path}.{self.rotations}")
        self._sink_header = False

    def close(self) -> None:
        """Flush and close the JSONL sink (no-op without one).

        Closing is not the end of the stream: events recorded *after*
        close — an engine-shutdown remesh, an end-of-run trigger — reopen
        the file and append to the same stream without a new header, so
        nothing written late is dropped from :meth:`read_jsonl`'s
        rebuild."""
        if self._sink is not None:
            self._sink.flush()
            self._sink.close()
            self._sink = None

    @classmethod
    def read_jsonl(cls, path: str) -> "CounterTimeline":
        """Rebuild a timeline from a streamed JSONL sink file.  The line
        format is: a header line ``{"schema", "source", "counters"}``,
        then one ``{"sample": {...}}`` or ``{"event": {...}}`` object per
        line.  A file holding several appended streams (the same sink
        path reused across runs) yields the LATEST stream — each header
        line is a stream restart, never a merge."""
        tl_ = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "schema" in obj:
                    if obj["schema"] not in TIMELINE_SCHEMAS:
                        raise ValueError(
                            f"unknown timeline sink schema {obj['schema']!r}")
                    tl_ = cls(source=obj.get("source", "run"),
                              counter_names=tuple(obj["counters"]))
                    continue
                if tl_ is None:
                    tl_ = cls()          # headerless stream
                if "sample" in obj:
                    s = obj["sample"]
                    tl_.snapshot(s["step"], s["tenants"],
                                 gauges=s.get("gauges"), t=s["t"])
                elif "event" in obj:
                    tl_.events.append(obj["event"])
        return tl_ if tl_ is not None else cls()

    @classmethod
    def read_rotated(cls, path: str) -> "CounterTimeline":
        """Rebuild ONE logical run from a rotated sink: sealed segments
        ``path.1 .. path.N`` (oldest first) then the live ``path`` are
        concatenated.  Each segment opens with its own header (so any
        single segment also reads standalone via :meth:`read_jsonl`), but
        here a header marks a *rotation boundary* of one stream, not a
        run restart — samples and events accumulate across segments."""
        paths, k = [], 1
        while os.path.exists(f"{path}.{k}"):
            paths.append(f"{path}.{k}")
            k += 1
        if os.path.exists(path):
            paths.append(path)
        if not paths:
            raise FileNotFoundError(f"no sink segments at {path!r}")
        tl_ = None
        for p in paths:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    if "schema" in obj:
                        if obj["schema"] not in TIMELINE_SCHEMAS:
                            raise ValueError(f"unknown timeline sink "
                                             f"schema {obj['schema']!r}")
                        if tl_ is None:
                            tl_ = cls(source=obj.get("source", "run"),
                                      counter_names=tuple(obj["counters"]))
                        continue
                    if tl_ is None:
                        tl_ = cls()        # headerless stream
                    if "sample" in obj:
                        s = obj["sample"]
                        tl_.snapshot(s["step"], s["tenants"],
                                     gauges=s.get("gauges"), t=s["t"])
                    elif "event" in obj:
                        tl_.events.append(obj["event"])
        return tl_ if tl_ is not None else cls()

    # ------------------------------------------------------------------
    # derived series
    # ------------------------------------------------------------------
    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    def _value(self, sample: dict, tenant: str, counter: str) -> float:
        return float(sample["tenants"].get(tenant, {}).get(counter, 0.0))

    def rate_axis(self) -> dict[str, list]:
        """Window-end coordinates for every rates() series: the step and
        wall-time stamp of each window's closing sample."""
        return {"step": [s["step"] for s in self.samples[1:]],
                "t": [s["t"] for s in self.samples[1:]]}

    def _window(self, prev: dict, cur: dict,
                tenants: Sequence[str] | None = None
                ) -> dict[str, dict[str, float]]:
        """Derived rates for ONE window between two samples:
        ``{tenant: {field: value}}`` — every tenant seen so far, or just
        ``tenants`` (intersected with the seen set) when a caller like a
        scoped :class:`ThresholdWatcher` only needs a few."""
        if tenants is None:
            tenants = self._tenants
        else:
            tenants = [tn for tn in tenants if tn in self._tenants]
        dt = cur["t"] - prev["t"]
        if dt <= 0:
            dt = float(max(cur["step"] - prev["step"], 1))
        out: dict[str, dict[str, float]] = {}
        for tn in tenants:
            d = {c: max(self._value(cur, tn, c)
                        - self._value(prev, tn, c), 0.0)
                 for c in self.counter_names}
            ops = d.get("ops", 0.0)
            pct = (lambda n: 100.0 * n / ops if ops > 0 else 0.0)
            comp = d.get("completions", 0.0)
            out[tn] = {
                "ops_s": ops / dt,
                "bytes_s": d.get("bytes", 0.0) / dt,
                "chunks_s": d.get("chunks", 0.0) / dt,
                "throttled_pct": pct(d.get("throttled", 0.0)),
                "stalls_pct": pct(d.get("stalls", 0.0)),
                "denied_pct": pct(d.get("denied", 0.0)),
                # cq_depth is a high-water mark, not additive: report the
                # level at the window's close.
                "cq_depth": self._value(cur, tn, "cq_depth"),
                "retrans_s": d.get("retransmits", 0.0) / dt,
                "timeouts_s": d.get("timeouts", 0.0) / dt,
                "srq_grants_s": d.get("srq_grants", 0.0) / dt,
                "cqe_err_pct": (100.0 * d.get("cqe_errors", 0.0) / comp
                                if comp > 0 else 0.0),
                "preempt_s": d.get("preemptions", 0.0) / dt,
                "restore_s": d.get("restores", 0.0) / dt,
            }
        return out

    def window_rates(self, i: int = -1,
                     tenants: Sequence[str] | None = None
                     ) -> dict[str, dict[str, float]]:
        """Rates for the single window closing at ``samples[i]``
        (``i >= 1`` or negative; the newest window by default) — what a
        :class:`ThresholdWatcher` consumes incrementally, optionally
        restricted to ``tenants`` so a scoped watcher pays O(watched
        tenants), not O(all tenants).  Returns ``{}`` while fewer than
        two samples exist."""
        n = len(self.samples)
        if n < 2:
            return {}
        if i < 0:
            i += n
        if not 1 <= i < n:
            raise IndexError(f"window index {i} outside [1, {n - 1}]")
        return self._window(self.samples[i - 1], self.samples[i],
                            tenants=tenants)

    def rates(self) -> dict[str, dict[str, list[float]]]:
        """Per-tenant derived series, one value per window between
        consecutive samples: ``{tenant: {field: [v, ...]}}``.

        Deltas divide by the window's wall time; a non-positive wall
        delta (explicit equal stamps, clock weirdness) falls back to the
        step delta so the series stays finite and deterministic."""
        out: dict[str, dict[str, list[float]]] = {
            tn: {f: [] for f in RATE_FIELDS} for tn in self._tenants}
        for prev, cur in zip(self.samples, self.samples[1:]):
            w = self._window(prev, cur)
            for tn in self._tenants:
                for f in RATE_FIELDS:
                    out[tn][f].append(w[tn][f])
        return out

    def gauge_series(self) -> dict[str, list[float]]:
        """Run-wide gauges aligned to the sample axis (not windows)."""
        return {g: [float(s["gauges"].get(g, 0.0)) for s in self.samples]
                for g in self._gauge_names}

    # ------------------------------------------------------------------
    # artifact
    # ------------------------------------------------------------------
    def to_doc(self) -> dict:
        return {
            "schema": TIMELINE_SCHEMA,
            "source": self.source,
            "counters": list(self.counter_names),
            "rate_fields": list(RATE_FIELDS),
            "tenants": list(self._tenants),
            "samples": self.samples,
            "events": list(self.events),
            "axis": self.rate_axis(),
            "rates": self.rates(),
            "gauges": self.gauge_series(),
        }

    def save(self, path: str) -> str:
        """Write the schema-versioned JSON artifact; returns ``path``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1)
        return path

    @staticmethod
    def load(path: str) -> dict:
        """Load and validate an artifact; returns the document dict."""
        with open(path) as f:
            doc = json.load(f)
        validate_timeline(doc)
        return doc

    # ------------------------------------------------------------------
    # console panels
    # ------------------------------------------------------------------
    def panel(self, width: int = 48,
              fields: tuple[str, ...] = RATE_FIELDS) -> str:
        """Per-tenant ASCII sparkline panels (plus run-wide gauges).

        All-zero series other than ``ops_s``/``bytes_s`` are elided so a
        quiet tenant stays one glanceable block."""
        lines: list[str] = []
        rates = self.rates()
        for tn in self._tenants:
            lines.append(f"-- tenant {tn} ({self.source}, "
                         f"{len(self.samples)} samples) ".ljust(width + 18, "-"))
            for f in fields:
                series = rates[tn][f]
                if not series:
                    continue
                if f not in ("ops_s", "bytes_s") and not any(series):
                    continue
                lines.append(f"  {f:14s} {sparkline(series, width):{width}s}"
                             f" last {series[-1]:.1f}")
        gauges = self.gauge_series()
        if gauges:
            lines.append(f"-- run gauges ".ljust(width + 18, "-"))
            for g, series in gauges.items():
                lines.append(f"  {g:14s} {sparkline(series, width):{width}s}"
                             f" last {series[-1]:.1f}")
        return "\n".join(lines)


def validate_timeline(doc: dict) -> dict:
    """Structural check of a timeline artifact; raises ValueError on a
    malformed document, returns it unchanged otherwise (so call sites can
    chain).  This is the CI smoke's assertion and the forward-compat
    gate: every known schema version is checked against its own layout
    (v1 = v2 without the ``events`` list), unknown versions are refused,
    not misread, and every series is length-checked against the sample
    axis — a truncated ``rates``/``gauges``/``axis`` series is rejected
    even on a v1 document."""
    if not isinstance(doc, dict):
        raise ValueError(f"timeline artifact must be a dict, got {type(doc)}")
    schema = doc.get("schema")
    if schema not in TIMELINE_SCHEMAS:
        raise ValueError(f"unknown timeline schema {schema!r} "
                         f"(expected one of {TIMELINE_SCHEMAS})")
    required = ["source", "counters", "rate_fields", "tenants", "samples",
                "axis", "rates", "gauges"]
    if schema == TIMELINE_SCHEMA:
        required.append("events")
    for key in required:
        if key not in doc:
            raise ValueError(f"timeline artifact missing key {key!r}")
    n_samples = len(doc["samples"])
    n_windows = max(n_samples - 1, 0)
    for ax in ("step", "t"):
        if len(doc["axis"].get(ax, ())) != n_windows:
            raise ValueError(f"timeline axis {ax!r} length != sample windows")
    for s in doc["samples"]:
        for key in ("step", "t", "tenants", "gauges"):
            if key not in s:
                raise ValueError(f"timeline sample missing key {key!r}")
    for tn in doc["tenants"]:
        series = doc["rates"].get(tn)
        if series is None:
            raise ValueError(f"timeline rates missing tenant {tn!r}")
        for f in doc["rate_fields"]:
            if len(series.get(f, ())) != n_windows:
                raise ValueError(
                    f"rate series {tn}/{f} length != window count")
    for g, series in doc["gauges"].items():
        if len(series) != n_samples:
            raise ValueError(f"gauge series {g!r} length != sample count")
    for ev in doc.get("events", ()):
        for key in ("kind", "step"):
            if key not in ev:
                raise ValueError(f"timeline event missing key {key!r}")
    return doc


def merge_timelines(parts: Sequence[CounterTimeline], *,
                    source: str = "pod") -> CounterTimeline:
    """Merge per-process timelines into one pod-level timeline
    (docs/observability.md) — the cross-host half of the control plane:
    every process snapshots its own counters locally, the controller host
    merges them step-aligned and runs the watcher hierarchy over the
    merged rate series.

    Semantics:

    * **step-aligned, never truncated**: all parts must carry the same
      number of samples and sample ``i`` of every part must stamp the
      same step — a lagging or over-eager host raises ``ValueError``
      rather than silently dropping the tail (a misaligned pod merge is
      an upstream bug, and a merged artifact built from it would lie).
    * counter layouts must match; additive counters **sum** across parts
      per tenant, while ``cq_depth`` (a high-water level) takes the
      **max** — the same convention as the benchmark's
      ``accumulate_report``.
    * the merged sample's wall stamp is the **latest** part stamp (the
      pod window closes when the last process reports) and gauges sum.
    * events from every part interleave sorted by ``(step, t)``, each
      tagged with its origin timeline's ``source`` in
      ``detail["origin"]``.

    The result is an ordinary :class:`CounterTimeline` (schema
    ``cord-timeline/v2``): it saves, validates, renders panels and feeds
    watchers exactly like a single-process one."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge_timelines needs at least one timeline")
    names = parts[0].counter_names
    for p in parts[1:]:
        if p.counter_names != names:
            raise ValueError(
                f"cannot merge timelines with different counter layouts: "
                f"{parts[0].source!r} has {names}, {p.source!r} has "
                f"{p.counter_names}")
    n = len(parts[0].samples)
    for p in parts[1:]:
        if len(p.samples) != n:
            raise ValueError(
                f"step-misaligned merge: {parts[0].source!r} has {n} "
                f"samples but {p.source!r} has {len(p.samples)} — refusing "
                f"to truncate; snapshot every process at every step")
    merged = CounterTimeline(source=source, counter_names=names)
    for i in range(n):
        steps = sorted({int(p.samples[i]["step"]) for p in parts})
        if len(steps) > 1:
            raise ValueError(f"step-misaligned merge: sample {i} stamps "
                             f"steps {steps} across parts")
        report: dict[str, dict[str, float]] = {}
        gauges: dict[str, float] = {}
        for p in parts:
            s = p.samples[i]
            for tn, ctrs in s["tenants"].items():
                acc = report.setdefault(tn, dict.fromkeys(names, 0.0))
                for c in names:
                    v = float(ctrs.get(c, 0.0))
                    acc[c] = max(acc[c], v) if c == "cq_depth" else acc[c] + v
            for g, v in s["gauges"].items():
                gauges[g] = gauges.get(g, 0.0) + float(v)
        merged.snapshot(steps[0], report, gauges=gauges,
                        t=max(float(p.samples[i]["t"]) for p in parts))
    tagged = [dict(ev, detail=dict(ev.get("detail") or {}, origin=p.source))
              for p in parts for ev in p.events]
    merged.events.extend(sorted(tagged,
                                key=lambda e: (e["step"], e.get("t", 0.0))))
    return merged


class ThresholdWatcher:
    """Hysteresis threshold watcher over a timeline's rate series — the
    trigger half of the elastic control loop (docs/elasticity.md).

    ``thresholds`` maps :data:`RATE_FIELDS` names to trigger levels.  A
    tenant *trips* when any watched field sits at/over its level for
    ``sustain`` consecutive windows; tripping emits one trigger event,
    resets the tenant's streak and starts a ``cooldown`` of that many
    windows during which the tenant cannot accumulate a new streak.  One
    transient over-threshold window (or one quiet window inside a streak)
    therefore never triggers, and a persistently bad tenant triggers once
    per cooldown period, not once per window.

    The optional **release arm** closes the shrink→grow cycle
    (docs/elasticity.md): after a trigger *arms* a tenant, sustained
    quiet — every ``release`` field strictly *below* its level for
    ``release_sustain`` consecutive windows — emits one ``recover`` event
    and starts a separate ``release_cooldown``.  Release levels must sit
    strictly below their trigger thresholds: the gap is the hysteresis
    band, so a rate parked *on* a level oscillates neither arm.  A tenant
    never recovers while still inside the trigger cooldown, and a window
    that trips (or merely sits over a trigger threshold) resets any
    recovery streak.

    :meth:`observe` is incremental — each call consumes only the windows
    appended since the last call, and each window derives rates only for
    the watched tenants, so it can run after every snapshot at
    O(new windows × watched tenants) cost.  The watcher is pure host-side
    bookkeeping on host floats: it never touches a tensor."""

    def __init__(self, thresholds: dict[str, float], *, sustain: int = 3,
                 cooldown: int = 8, tenants: Sequence[str] | None = None,
                 release: dict[str, float] | None = None,
                 release_sustain: int | None = None,
                 release_cooldown: int | None = None):
        unknown = set(thresholds) - set(RATE_FIELDS)
        if unknown:
            raise ValueError(f"unknown rate fields {sorted(unknown)} "
                             f"(known: {RATE_FIELDS})")
        if not thresholds:
            raise ValueError("ThresholdWatcher needs at least one threshold")
        if sustain < 1 or cooldown < 0:
            raise ValueError(f"need sustain >= 1 and cooldown >= 0, got "
                             f"{sustain}/{cooldown}")
        self.thresholds = {k: float(v) for k, v in thresholds.items()}
        self.sustain = int(sustain)
        self.cooldown = int(cooldown)
        self.tenants = tuple(tenants) if tenants else None
        self.release = ({k: float(v) for k, v in release.items()}
                        if release else None)
        if self.release:
            unknown = set(self.release) - set(RATE_FIELDS)
            if unknown:
                raise ValueError(f"unknown release rate fields "
                                 f"{sorted(unknown)} (known: {RATE_FIELDS})")
            for f, lv in self.release.items():
                if f in self.thresholds and lv >= self.thresholds[f]:
                    raise ValueError(
                        f"release level {f}={lv} must sit below its trigger "
                        f"threshold {self.thresholds[f]} — the gap is the "
                        f"hysteresis band that damps oscillation")
        self.release_sustain = int(sustain if release_sustain is None
                                   else release_sustain)
        self.release_cooldown = int(cooldown if release_cooldown is None
                                    else release_cooldown)
        if self.release_sustain < 1 or self.release_cooldown < 0:
            raise ValueError(
                f"need release_sustain >= 1 and release_cooldown >= 0, got "
                f"{self.release_sustain}/{self.release_cooldown}")
        self.triggers: list[dict] = []     # every trigger ever emitted
        self.releases: list[dict] = []     # every recover ever emitted
        self._streak: dict[str, int] = {}
        self._cool: dict[str, int] = {}
        self._armed: dict[str, bool] = {}  # tripped, not yet recovered
        self._rstreak: dict[str, int] = {}
        self._rcool: dict[str, int] = {}
        self._seen = 0                     # windows consumed so far

    @classmethod
    def from_config(cls, cfg) -> "ThresholdWatcher":
        """Build from an :class:`~repro_torch.configs.base.ElasticConfig`,
        whose ``thresholds`` (and optional ``release_thresholds``, the
        grow-back arm) are CLI-friendly ``"rate_field=level"`` strings."""
        def parse(specs):
            out: dict[str, float] = {}
            for spec in specs:
                name, sep, level = spec.partition("=")
                if not sep:
                    raise ValueError(f"threshold spec must be "
                                     f"'rate_field=level', got {spec!r}")
                out[name.strip()] = float(level)
            return out

        rel = parse(getattr(cfg, "release_thresholds", ()) or ())
        return cls(parse(cfg.thresholds), sustain=cfg.sustain,
                   cooldown=cfg.cooldown, tenants=cfg.tenants or None,
                   release=rel or None,
                   release_sustain=getattr(cfg, "release_sustain", None),
                   release_cooldown=getattr(cfg, "release_cooldown", None))

    def observe(self, timeline: CounterTimeline) -> list[dict]:
        """Consume every not-yet-seen window of ``timeline``; returns the
        ``trigger`` (and, with a release arm, ``recover``) events fired
        by those windows, often empty.  Event dicts match
        :meth:`CounterTimeline.record_event`'s shape so callers can log
        them straight into the artifact."""
        fired: list[dict] = []
        n_windows = max(len(timeline.samples) - 1, 0)
        while self._seen < n_windows:
            i = self._seen + 1            # sample index closing this window
            window = timeline.window_rates(i, tenants=self.tenants)
            close = timeline.samples[i]
            for tn, fields in window.items():
                if self._cool.get(tn, 0) > 0:
                    # trigger cooldown freezes BOTH arms: no re-trip, and
                    # no grow-back progress while the shrink settles
                    self._cool[tn] -= 1
                    self._streak[tn] = 0
                    self._rstreak[tn] = 0
                    continue
                over = {f: fields.get(f, 0.0)
                        for f, lim in self.thresholds.items()
                        if fields.get(f, 0.0) >= lim}
                self._streak[tn] = self._streak.get(tn, 0) + 1 if over else 0
                if over and self._streak[tn] >= self.sustain:
                    ev = {"kind": "trigger", "step": int(close["step"]),
                          "t": float(close["t"]), "tenant": tn,
                          "detail": {"over": over,
                                     "sustained": self._streak[tn]}}
                    fired.append(ev)
                    self.triggers.append(ev)
                    self._streak[tn] = 0
                    self._cool[tn] = self.cooldown
                    if self.release:
                        self._armed[tn] = True
                        self._rstreak[tn] = 0
                    continue
                # ---- release (grow-back) arm ------------------------------
                if not self.release or not self._armed.get(tn):
                    continue
                if self._rcool.get(tn, 0) > 0:
                    self._rcool[tn] -= 1
                    self._rstreak[tn] = 0
                    continue
                under = {f: fields.get(f, 0.0)
                         for f, lim in self.release.items()
                         if fields.get(f, 0.0) < lim}
                if over or len(under) < len(self.release):
                    # any release field at/over its level — or a fresh
                    # over-threshold window — cancels recovery progress
                    self._rstreak[tn] = 0
                    continue
                self._rstreak[tn] = self._rstreak.get(tn, 0) + 1
                if self._rstreak[tn] >= self.release_sustain:
                    ev = {"kind": "recover", "step": int(close["step"]),
                          "t": float(close["t"]), "tenant": tn,
                          "detail": {"under": under,
                                     "sustained": self._rstreak[tn]}}
                    fired.append(ev)
                    self.releases.append(ev)
                    self._armed[tn] = False
                    self._rstreak[tn] = 0
                    self._rcool[tn] = self.release_cooldown
            self._seen += 1
        return fired

    def gauges(self) -> dict[str, float]:
        """Run-wide watcher gauges to ride along in snapshots
        (docs/observability.md): the largest over-threshold streak and
        the largest remaining cooldown across watched tenants, as of the
        windows observed so far.  With a release arm configured, the
        grow-back side's streak/cooldown ride along too."""
        g = {"watch_streak": float(max(self._streak.values(), default=0)),
             "watch_cooldown": float(max(self._cool.values(), default=0))}
        if self.release:
            g["watch_release_streak"] = float(
                max(self._rstreak.values(), default=0))
            g["watch_release_cooldown"] = float(
                max(self._rcool.values(), default=0))
        return g


class WatcherGroup:
    """A named hierarchy of watchers driven off ONE timeline — typically
    the merged pod timeline from :func:`merge_timelines`, so a
    train-remesh watcher and a serve-budget watcher read the same
    cluster-wide rate series (docs/elasticity.md).

    :meth:`observe` consumes the new windows through every member
    incrementally, tags each fired event's detail with the member's name
    (``detail["watcher"]``), records the events into the timeline's
    artifact (unless ``record=False``) and returns them per member, so a
    controller picks up exactly its own watcher's events:
    ``evs = group.observe(pod); train_ctl.respond(state, step,
    evs["train"]); serve_ctl.respond(evs["serve"])``."""

    def __init__(self, watchers: dict[str, ThresholdWatcher]):
        if not watchers:
            raise ValueError("WatcherGroup needs at least one watcher")
        for name, w in watchers.items():
            if not isinstance(w, ThresholdWatcher):
                raise ValueError(f"watcher {name!r} is not a "
                                 f"ThresholdWatcher: {type(w)}")
        self.watchers = dict(watchers)

    def observe(self, timeline: CounterTimeline, *,
                record: bool = True) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {}
        for name, w in self.watchers.items():
            events = w.observe(timeline)
            for ev in events:
                ev["detail"]["watcher"] = name
                if record:
                    timeline.record_event(ev["kind"], ev["step"],
                                          tenant=ev["tenant"], t=ev["t"],
                                          detail=ev["detail"])
            out[name] = events
        return out

    def gauges(self) -> dict[str, float]:
        """Every member's gauges, namespaced ``<name>_<gauge>``."""
        return {f"{name}_{k}": v for name, w in self.watchers.items()
                for k, v in w.gauges().items()}


__all__ = ["CounterTimeline", "ThresholdWatcher", "WatcherGroup",
           "merge_timelines", "sparkline",
           "validate_timeline", "TIMELINE_SCHEMA", "TIMELINE_SCHEMA_V1",
           "TIMELINE_SCHEMAS", "RATE_FIELDS"]

"""The benchmark's own tracing: spans around the calls it makes into the
port, the port's launch counters read at each span's edges, and a
profiled slice of the window read from torch.profiler.

Spans are synchronised at both ends, so they exist only in a traced run
(``--trace 1``); the untraced run records nothing but its own stamps.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import defaultdict

import torch


def launch_counts() -> dict:
    """The port's kernel launch counters: each wrapper counts its own
    launches exactly."""
    from repro_torch.kernels.dataplane import bounce, stall
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as ssm
    return {"bounce": bounce.LAUNCHES, "bounce_stall": stall.LAUNCHES,
            "flash_attention": flash.LAUNCHES,
            "flash_bwd": flash.BWD_LAUNCHES, "ssm_scan": ssm.LAUNCHES,
            "ssm_scan_bwd": ssm.BWD_LAUNCHES}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Synchronised spans: ``(kind, start, end, launches, info)`` rows,
    perf_counter seconds, launches as the counters' delta.  ``before``
    maps a row's index to a function called just before that call is
    made (and its span opened): what starts and stops a profiled slice
    between two calls."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.rows: list[dict] = []
        self.before: dict = {}

    def call(self, kind: str, fn, *args, info=None, **kw):
        hook = self.before.pop(len(self.rows), None)
        if hook is not None:
            hook()
        _sync(self.device)
        n0, t0 = launch_counts(), time.perf_counter()
        with torch.profiler.record_function(f"cordbench.{kind}"):
            out = fn(*args, **kw)
            _sync(self.device)
        t1 = time.perf_counter()
        n1 = launch_counts()
        self.rows.append({"kind": kind, "start": t0, "end": t1,
                          "launches": {k: n1[k] - n0[k] for k in n1},
                          "info": info or {}})
        return out

    def of(self, kind: str) -> list[dict]:
        return [r for r in self.rows if r["kind"] == kind]


def spanned_model(model, spans: Spans):
    """``model`` with its serving entries (prefill, prefill chunk, slot
    decode) each run inside a span that keeps the call's token count."""
    def wrap(kind, fn):
        def call(params, batch, *args, **kw):
            n = (batch["tokens"].shape[1] if isinstance(batch, dict)
                 else batch.shape[1])
            return spans.call(kind, fn, params, batch, *args,
                              info={"tokens": int(n)}, **kw)
        return call
    return dataclasses.replace(
        model, prefill=wrap("prefill", model.prefill),
        prefill_chunk=model.prefill_chunk and wrap("chunk",
                                                   model.prefill_chunk),
        decode_step_slots=wrap("decode", model.decode_step_slots))


class Profiled:
    """torch.profiler over a slice of the window.  After the slice:
    ``kernels`` (name, start us, end us) of every device operation,
    ``spans`` (label, start us, end us) of the benchmark's spans, and
    ``window`` (start us, end us) of the slice."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.kernels: list[tuple[str, float, float]] = []
        self.spans: list[tuple[str, float, float]] = []
        self.window = (0.0, 0.0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = torch.profiler.record_function("cordbench.slice")
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def collect(self) -> "Profiled":
        """Read the profiler's events (slow: call it once the window has
        closed)."""
        if not hasattr(self, "_prof"):
            return self
        from torch.autograd import DeviceType
        for e in self._prof.events():
            rng = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                # the device side of a record_function range is no work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("cordbench.")):
                    self.kernels.append(rng)
            elif e.name == "cordbench.slice":
                self.window = rng[1:]
            elif e.name.startswith("cordbench."):
                self.spans.append((e.name[len("cordbench."):],) + rng[1:])
        self.kernels.sort(key=lambda k: k[1])
        self.spans.sort(key=lambda s: s[1])
        self._starts = [s for _, s, _ in self.spans]
        del self._prof
        return self

    # -- readings ----------------------------------------------------------
    def busy_us(self) -> float:
        """Microseconds of the slice in which some device operation ran:
        the union of their intervals."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for _, s, e in self.kernels:
            s, e = max(s, end, lo), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, match) -> float:
        """Device microseconds of the operations whose name ``match``
        accepts."""
        return sum(e - s for name, s, e in self.kernels if match(name))

    def span_of(self, t: float) -> str | None:
        """The innermost span holding time ``t``."""
        i = bisect.bisect_right(self._starts, t)
        best = None
        for label, s, e in self.spans[max(0, i - 64):i]:
            if s <= t <= e:
                best = label
        return best

    def device_us_in(self, kind: str) -> tuple[float, int]:
        """(device microseconds of the operations that start inside spans
        of ``kind``, number of those spans)."""
        total = 0.0
        for name, s, e in self.kernels:
            if self.span_of(s) == kind:
                total += e - s
        return total, sum(1 for label, _, _ in self.spans if label == kind)

    def idle_gaps(self) -> dict:
        """Idle device microseconds of the slice by what the host was in:
        the span holding the gap's middle (or "no span") and the device
        operation that ended it."""
        lo, hi = self.window
        out: dict = defaultdict(float)
        end = lo
        for name, s, e in self.kernels + [("(slice end)", hi, hi)]:
            if s > end:
                a, b = end, min(s, hi)
                if b > a:
                    where = self.span_of((a + b) / 2) or "no span"
                    out[f"{where} before {short(name)}"] += b - a
            end = max(end, e)
        return dict(out)

    def by_op(self) -> list:
        """[short name, launches, microseconds] of the device operations,
        the most time first."""
        c: dict = defaultdict(lambda: [0, 0.0])
        for name, s, e in self.kernels:
            c[short(name)][0] += 1
            c[short(name)][1] += e - s
        return sorted(([k, v[0], v[1]] for k, v in c.items()),
                      key=lambda r: -r[2])

    def breakdown(self) -> dict:
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, us / 1e6] for k, _, us in
                               self.by_op()[:10]],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps[:10]]}


def short(name: str, n: int = 80) -> str:
    """A kernel name without its parameters, its template arguments cut to
    the first ATen functor or kernel they name (which tells a cast from an
    add)."""
    if not name:
        return "(unnamed kernel)"
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    head = base.split("(")[0].split("<")[0].split("::")[-1]
    inner = [w for w in re.findall(r"at::native::(\w+)", base)
             if w != head and not w.startswith("gpu_kernel")]
    return (f"{head}[{inner[0]}]" if inner else head)[:n]

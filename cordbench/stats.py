"""Window arithmetic: rates over the whole window, percentiles over every
request, time per output token from token stamps."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_ms(submitted: float, first: float) -> float:
    """Time to first token: from the wave's submit stamp to the host
    holding the request's first token, queueing included."""
    return (first - submitted) * 1e3


def tpot_ms(stamps) -> float | None:
    """Mean gap between a request's output tokens: (last - first) over
    (tokens - 1); None for a request with one token."""
    if len(stamps) < 2:
        return None
    return (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)


def rate(count: float, seconds: float) -> float:
    return count / seconds

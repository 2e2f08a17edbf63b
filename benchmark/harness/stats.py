"""Order statistics of the benchmark's timings."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, interpolated linearly
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def summary(values) -> dict:
    """Median, 95th percentile and the number of samples."""
    return {"median": percentile(values, 50), "p95": percentile(values, 95),
            "n": len(values)}

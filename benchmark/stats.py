"""The benchmark's statistics, in plain Python."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between the closest
    ranks (numpy's default): rank ``q / 100 * (n - 1)`` of the sorted values."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    r = q / 100 * (len(v) - 1)
    lo = int(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


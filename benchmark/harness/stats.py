"""Tails and rates over every request and the whole window.

A tail is taken over all requests due in the window: one that failed or
has no answer when the run ends enters as infinitely late, so it can only
raise the tail, never drop out of it.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100), linear between the two nearest
    ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(times: Iterable[float], start: float, end: float) -> float:
    """Events a second over the whole window [start, end)."""
    return sum(1 for t in times if start <= t < end) / (end - start)

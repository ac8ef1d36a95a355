"""The arithmetic that turns a window's samples and intervals into numbers."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of all ``values``: the smallest
    value with at least ``p`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of ``(start, end)`` intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """How much of ``[lo, hi]`` the disjoint sorted intervals cover."""
    total = 0.0
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(b, hi) - max(a, lo)
    return total


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that the disjoint sorted intervals leave
    uncovered."""
    out, pos = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > pos:
            out.append((pos, a))
        pos = max(pos, b)
    if pos < hi:
        out.append((pos, hi))
    return out


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def quarter_rates(ends: Sequence[float], start: float, per_call: float = 1.0) -> List[float]:
    """The rate of work in each quarter of a window that starts at
    ``start`` and ends with the last of the calls ending at ``ends``: a
    call counts in the quarter in which it ends."""
    if not ends:
        return []
    span = (ends[-1] - start) / 4.0
    counts = [0, 0, 0, 0]
    for t in ends:
        counts[min(int((t - start) / span), 3) if span > 0 else 3] += 1
    return [c * per_call / span if span > 0 else 0.0 for c in counts]

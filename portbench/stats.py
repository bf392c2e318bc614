"""Arithmetic of the benchmark's numbers: the tail of a latency sample
and unions of device intervals."""

from __future__ import annotations

import math


def p95(values) -> float:
    """The 95th percentile by nearest rank, over every value given."""
    vals = sorted(values)
    if not vals:
        raise ValueError("p95 of no values")
    return vals[max(0, math.ceil(0.95 * len(vals)) - 1)]


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out

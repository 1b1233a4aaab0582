"""The benchmark's arithmetic: rates over a window and the union of
device intervals."""

from __future__ import annotations


def rate(done: int, window_s: float) -> float:
    """Work done over the whole window's time."""
    if window_s <= 0:
        raise ValueError("empty window")
    return done / window_s


def union(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Time inside ``[lo, hi]`` covered by at least one interval."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out

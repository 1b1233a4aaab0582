"""Phase timing and the CLI's ``stats:`` block."""

from __future__ import annotations

import time


class StopWatch:
    def __init__(self) -> None:
        self._t = time.monotonic()

    def reset(self) -> float:
        now = time.monotonic()
        dt = now - self._t
        self._t = now
        return dt


class Timings:
    """Accumulates named phases; prints the stats block."""

    def __init__(self) -> None:
        self.entries: list[tuple[str, float]] = []
        self._watch = StopWatch()

    def mark(self, name: str) -> float:
        dt = self._watch.reset()
        self.entries.append((name, dt))
        return dt

    @property
    def total(self) -> float:
        return sum(t for _, t in self.entries)

    def print_stats(self, n_queries: int | None = None, n_hits: int | None = None) -> None:
        print("stats:")
        for key, t in self.entries:
            print(f"  {key + ' time:':<20} {t:> 10.2f}s")
        total = self.total
        print(f"  total time:          {total:> 10.2f}s")
        if n_queries is not None:
            qps = n_queries / total if total > 0 else float("inf")
            print(f"  queries per second:  {qps:> 10.0f}q/s")
        if n_hits is not None:
            print(f"  number of hits:      {n_hits:>10}")

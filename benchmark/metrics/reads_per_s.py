"""Reads whose hits came back to the host, over the whole window's time
(a read is searched on both strands and counts once)."""

from benchmark import stats


def read(rec):
    return stats.rate(rec["reads_done"], rec["window_s"])

"""Launches of K5 (``workq_step``, one a work-queue step) per 1,000 reads
of the window, from the program's launch counter."""


def read(rec):
    n = rec["launches"].get("workq_step", 0)
    if n == 0 or rec["reads_done"] == 0:
        return None
    return n / (rec["reads_done"] / 1e3)

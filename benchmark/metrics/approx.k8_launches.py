"""Launches of K8 (``frontier_step``, retry rungs included) per 1,000
reads of the window, from the program's launch counter."""


def read(rec):
    n = rec["launches"].get("frontier_step", 0)
    if n == 0 or rec["reads_done"] == 0:
        return None
    return n / (rec["reads_done"] / 1e3)

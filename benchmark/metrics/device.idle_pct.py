"""Share of the traced batches' wall time in which no kernel, copy or set
ran on the card (the union of their intervals)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

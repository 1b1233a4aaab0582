"""Device time of the program's own kernels (its ``__global__`` functions,
matched by whole name) per 1,000 reads of the traced batches."""

import re


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    pattern = re.compile(r"(?<!\w)(" + "|".join(map(re.escape, tr["port_kernels"])) + r")(?!\w)")
    seconds = sum(s for name, s in tr["kernels"] if pattern.search(name))
    if seconds == 0:
        return None
    return seconds * 1e3 / (tr["reads"] / 1e3)

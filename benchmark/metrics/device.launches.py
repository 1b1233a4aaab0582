"""Kernel launches the profiler saw (the program's and PyTorch's) per
1,000 reads of the traced batches."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return len(tr["kernels"]) / (tr["reads"] / 1e3)

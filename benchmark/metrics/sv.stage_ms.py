"""The seed-and-verify chunks' stage timer (CUDA events at the stage
boundaries, so device-stream time between them, idle gaps included),
summed over its five stages, per 1,000 reads of the window."""


def read(rec):
    stages = rec.get("stages_ms")
    if not stages or sum(stages.values()) == 0:
        return None
    return sum(stages.values()) / (rec["reads_done"] / 1e3)

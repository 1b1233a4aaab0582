"""The process's CPU time over the window (every thread's, from
``time.process_time``) per 1,000 reads: the host's work without the time
the process waited for the card or for a core."""


def read(rec):
    if rec["reads_done"] == 0:
        return None
    return rec["cpu_s"] * 1e3 / (rec["reads_done"] / 1e3)

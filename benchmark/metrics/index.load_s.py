"""Host time of loading the cached index file."""


def read(rec):
    return rec["spans"]["index.load_s"]

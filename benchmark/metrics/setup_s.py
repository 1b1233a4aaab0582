"""Process start to the window's start: imports, the CUDA context, the
kernel libraries from the checkout's build, the index load and upload,
the read pool and one warm pass over it."""


def read(rec):
    return rec["setup_s"]

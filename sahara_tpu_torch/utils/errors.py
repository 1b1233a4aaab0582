"""User-facing error type: ``main`` prints it and exits with 1."""


class SaharaError(RuntimeError):
    pass

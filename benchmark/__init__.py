"""The benchmark of ``sahara_tpu_torch``: see README.md and ``run.py``."""

"""What the port's tests share: PyTorch on one intra-op thread.

Importing this module calls ``torch.set_num_threads(1)``. The port's CPU
paths run many small integer operators, which a pool of one thread a core
does not speed up: its idle threads spin, and take the cores of the other
test workers on the host. Every ``tests/test_torch_*.py`` imports this
module, and a pytest worker imports every module it collects, so the
setting holds before the first port test runs. Python subprocesses that a
test starts take ``ONE_THREAD_ENV`` in their environment.

It imports neither JAX nor ``sahara_tpu``: the card's tests import it too.
"""

import torch

torch.set_num_threads(1)

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}

"""sahara_tpu_torch — the seed-and-verify read mapper on PyTorch and CUDA.

A port of ``sahara_tpu`` (JAX on a TPU) to one NVIDIA Hopper card.  The
package stands alone: it imports ``torch`` and numpy, never ``jax`` and
nothing of ``sahara_tpu``, and keeps its own copies of the host layers it
needs (alphabet, index build and container, SA-IS, read simulator).

Layout follows the JAX package so each module's counterpart is easy to find:

- ``index/``   host FM-index build, ``.idx`` container, j-mer seed table;
- ``engine/``  device index, rank primitives, locate, seed-and-verify, driver;
- ``kernels/`` hand-written CUDA kernels (``csrc/``), their nvcc/ctypes loader,
  and a plain PyTorch version of each;
- ``sim/``     the read simulator and the benchmark reference generator.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
"""

__version__ = "0.1.0"

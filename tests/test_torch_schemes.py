"""sahara_tpu_torch's scheme copies against sahara_tpu's: every registered
generator, expanded and compiled to a tape, gives the same arrays.  Host
only: no JAX compile."""

import numpy as np
import pytest

from sahara_tpu.engine.tape import compile_tape as jax_compile_tape
from sahara_tpu.schemes import GENERATORS as JAX_GENERATORS
from sahara_tpu.schemes import expand as jax_expand
from sahara_tpu.schemes import limit_to_hamming as jax_limit_to_hamming
from sahara_tpu.schemes.costs import optimize_by_wnc_topdown as jax_optimize
from sahara_tpu_torch.engine.driver import load_scheme
from sahara_tpu_torch.engine.tape import compile_tape
from sahara_tpu_torch.schemes import GENERATORS, expand, limit_to_hamming
from sahara_tpu_torch.schemes.costs import node_count, optimize_by_wnc_topdown, weighted_node_count

from tests import torch_support  # noqa: F401  (PyTorch on one thread)


def _searches(scheme):
    return [(tuple(s.pi), tuple(s.l), tuple(s.u)) for s in scheme]


def _tape_arrays(tape):
    return [np.asarray(a) for a in (tape.side, tape.qpos, tape.lo, tape.hi)]


def test_same_generators_registered():
    assert list(GENERATORS) == list(JAX_GENERATORS)


@pytest.mark.parametrize("name", list(JAX_GENERATORS))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_expanded_schemes_and_tapes_match(name, k):
    oss = GENERATORS[name].generator(0, k, 0, 0)
    jax_oss = JAX_GENERATORS[name].generator(0, k, 0, 0)
    assert _searches(oss) == _searches(jax_oss)
    for m in (20, 36):
        ess, jax_ess = expand(oss, m), jax_expand(jax_oss, m)
        assert _searches(ess) == _searches(jax_ess)
        for a, b in zip(_tape_arrays(compile_tape(ess)), _tape_arrays(jax_compile_tape(jax_ess))):
            np.testing.assert_array_equal(a, b)
        ham, jax_ham = limit_to_hamming(ess), jax_limit_to_hamming(jax_ess)
        assert _searches(ham) == _searches(jax_ham)
        assert node_count(ess, 6, True) > 0


@pytest.mark.parametrize("edit", [True, False])
def test_dynamic_partition_and_load_scheme_match(edit):
    oss = GENERATORS["h2-k2"].generator(0, 2, 0, 0)
    jax_oss = JAX_GENERATORS["h2-k2"].generator(0, 2, 0, 0)
    part = optimize_by_wnc_topdown(oss, 50, 6, 100_000, edit)
    assert part == jax_optimize(jax_oss, 50, 6, 100_000, edit)
    want = jax_expand(jax_oss, part)
    if not edit:
        want = jax_limit_to_hamming(want)
    got = load_scheme("h2-k2", 0, 2, 50, edit=edit, sigma=6, n_text=100_000, dynamic=True)
    assert _searches(got) == _searches(want)
    assert weighted_node_count(got, 6, 100_000, edit) > 0

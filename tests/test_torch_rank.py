"""sahara_tpu_torch rank primitives against sahara_tpu's XLA rank path and
both Pallas rank kernels (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sahara_tpu.engine import rank as jax_rank
from sahara_tpu.index.build import build_bifmindex
from sahara_tpu.kernels.rank import pack_occ16 as jax_pack_occ16
from sahara_tpu.kernels.rank import rank_all_hbm, rank_all_vmem
from sahara_tpu_torch.engine import rank
from sahara_tpu_torch.kernels.rank import rank_all


@pytest.fixture(scope="module")
def occ_fixture():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 6, size=5000).astype(np.uint8), rng.integers(1, 5, size=700).astype(np.uint8)]
    host = build_bifmindex(seqs, 6, "d_dna5")
    occ16 = torch.from_numpy(rank.pack_occ16(host.occ))
    idx = rng.integers(0, host.n + 1, size=700).astype(np.int32)
    return host, occ16, idx


def test_rank_all_matches_xla_and_pallas(occ_fixture):
    host, occ16, idx = occ_fixture
    got = rank_all(occ16, host.sigma, torch.from_numpy(idx)).numpy()
    occ = jnp.asarray(host.occ)
    want = np.asarray(jax_rank.rank_all(occ, host.sigma, jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    packed = jax_pack_occ16(host.occ)
    vmem = rank_all_vmem(packed, host.sigma, jnp.asarray(idx), interpret=True)
    hbm = rank_all_hbm(packed, host.sigma, jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(vmem))
    np.testing.assert_array_equal(got, np.asarray(hbm))


def test_rank_sym_matches_xla(occ_fixture):
    host, occ16, idx = occ_fixture
    sym = np.random.default_rng(4).integers(0, host.sigma, size=idx.shape[0]).astype(np.int32)
    got = rank.rank_sym(occ16, host.sigma, torch.from_numpy(sym), torch.from_numpy(idx)).numpy()
    i = jnp.asarray(idx)
    want = jax_rank.rank_sym_word(jnp.asarray(host.occ), i >> 5, jnp.asarray(sym), i, 1, host.sigma)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_lf_and_symbol_match_xla(occ_fixture):
    host, occ16, idx = occ_fixture
    idx = np.minimum(idx, host.n - 1)  # rows of the BWT
    got = rank.lf(occ16, torch.from_numpy(host.c_arr), host.sigma, torch.from_numpy(idx)).numpy()
    occ, i = jnp.asarray(host.occ), jnp.asarray(idx)
    want = jax_rank.lf(occ, jnp.asarray(host.c_arr), host.sigma, i)
    np.testing.assert_array_equal(got, np.asarray(want))
    sym = rank.symbol_from_row(rank.occ_row(occ16, torch.from_numpy(idx)), host.sigma, torch.from_numpy(idx))
    want_sym = jax_rank.symbol_from_row(jax_rank.occ_row(occ, i), host.sigma, i)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(want_sym))


def test_sampled_bit_and_rank_match_xla(occ_fixture):
    host, _, idx = occ_fixture
    idx = np.minimum(idx, host.n - 1)
    sampled = torch.from_numpy(host.sampled)
    i = jnp.asarray(idx)
    want_bit = jax_rank.sampled_bit(jnp.asarray(host.sampled), i)
    want_rank = jax_rank.sampled_rank(jnp.asarray(host.sampled), i)
    np.testing.assert_array_equal(rank.sampled_bit(sampled, torch.from_numpy(idx)).numpy(), np.asarray(want_bit))
    np.testing.assert_array_equal(rank.sampled_rank(sampled, torch.from_numpy(idx)).numpy(), np.asarray(want_rank))


def test_popcount32_exhaustive_bytes():
    x = torch.arange(256, dtype=torch.int64)
    for shift in (0, 8, 16, 24):
        got = rank.popcount32(x << shift)
        want = torch.tensor([bin(v).count("1") for v in range(256)])
        assert torch.equal(got, want)
    assert rank.popcount32(torch.tensor([0xFFFFFFFF])).item() == 32


def test_rank_all_rejects_other_devices(occ_fixture):
    _, occ16, idx = occ_fixture
    with pytest.raises(ValueError):
        rank_all(occ16.to("meta"), 6, torch.from_numpy(idx))


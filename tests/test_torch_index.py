"""sahara_tpu_torch host index against sahara_tpu's: build arrays, the
``.idx`` container, the j-mer seed table and the device upload."""

import io

import numpy as np
import pytest
import torch

import sahara_tpu.index.build as jax_build
import sahara_tpu.index.fmindex as jax_fm
from sahara_tpu.index.jmer import build_jmer_lut as jax_build_jmer_lut
from sahara_tpu.index.textstore import pack_text4 as jax_pack_text4
from sahara_tpu_torch.engine.device import DeviceIndex
from sahara_tpu_torch.engine.rank import pack_occ16
from sahara_tpu_torch.index import build, fmindex
from sahara_tpu_torch.index.jmer import build_jmer_lut, pick_lut_j
from sahara_tpu_torch.index.textstore import pack_text4, unpack_text4

from tests.util import random_seqs

ARRAYS = ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs")


def _seqs(seed=0, sigma=5):
    return random_seqs(np.random.default_rng(seed), 5, min_len=300, max_len=3000, sigma=sigma)


def _assert_same_index(a, b):
    for name in ARRAYS + (("occ_rev",) if hasattr(b, "occ_rev") else ()):
        want = getattr(b, name)
        got = getattr(a, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (a.sigma, a.rate, a.n, a.alphabet_name) == (b.sigma, b.rate, b.n, b.alphabet_name)


@pytest.mark.parametrize("kind", ["fm", "bi"])
@pytest.mark.parametrize("rate", [8, 16])
def test_build_matches_jax(kind, rate):
    seqs = _seqs(rate)
    if kind == "fm":
        got = build.build_fmindex(seqs, 6, "d_dna5", rate=rate)
        want = jax_build.build_fmindex(seqs, 6, "d_dna5", rate=rate)
    else:
        got = build.build_bifmindex(seqs, 6, "d_dna5", rate=rate)
        want = jax_build.build_bifmindex(seqs, 6, "d_dna5", rate=rate)
    _assert_same_index(got, want)
    np.testing.assert_array_equal(got.seq_starts(), want.seq_starts())


def test_build_without_full_sa(monkeypatch):
    seqs = _seqs(3)
    assert build.build_fmindex(seqs, 6, "d_dna5").sa_abs is not None
    monkeypatch.setattr(build, "FULL_SA_MAX", 100)
    assert build.build_fmindex(seqs, 6, "d_dna5").sa_abs is None


def test_load_index_reads_jax_container():
    host = jax_build.build_bifmindex(_seqs(1), 6, "d_dna5")
    buf = io.BytesIO()
    jax_fm.save_index(buf, host)
    loaded = fmindex.load_index(io.BytesIO(buf.getvalue()))
    assert isinstance(loaded, fmindex.BiFMIndex)
    _assert_same_index(loaded, host)


def test_jax_reads_port_container(tmp_path):
    host = build.build_fmindex(_seqs(2), 6, "d_dna5")
    path = tmp_path / "port.idx"
    fmindex.save_index(str(path), host)
    _assert_same_index(jax_fm.load_index(str(path)), host)


def test_from_arrays_and_load_give_same_device_tensors(tmp_path):
    host = jax_build.build_bifmindex(_seqs(4), 6, "d_dna5")
    path = tmp_path / "jax.idx"
    jax_fm.save_index(str(path), host)
    arrays = {name: getattr(host, name) for name in ARRAYS + ("occ_rev",)}
    meta = {"kind": "bi", "sigma": host.sigma, "alphabet": host.alphabet_name,
            "rate": host.rate, "n": host.n, "mirrored": host.mirrored}
    a = DeviceIndex.from_host(fmindex.from_arrays(arrays, meta), device="cpu")
    b = DeviceIndex.from_host(fmindex.load_index(str(path)), device="cpu")
    for name in ("occ16", "c_arr", "sampled", "sample_seq", "sample_pos", "text4", "seq_starts", "lut", "sa_full"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.sigma, a.rate, a.n, a.lut_j) == (b.sigma, b.rate, b.n, b.lut_j)


@pytest.mark.parametrize("sigma,alphabet", [(6, "d_dna5"), (5, "d_dna4"), (3, "dr_dna4")])
@pytest.mark.parametrize("j", [2, 5])
def test_jmer_lut_matches_jax(sigma, alphabet, j):
    host = jax_build.build_fmindex(_seqs(5, sigma=sigma), sigma, alphabet)
    want = jax_build_jmer_lut(host.occ, host.c_arr, sigma, host.n, j)
    occ16 = torch.from_numpy(pack_occ16(host.occ))
    got = build_jmer_lut(occ16, torch.from_numpy(host.c_arr), sigma, host.n, j)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_index_lut_and_sidecar():
    host = build.build_fmindex(_seqs(6), 6, "d_dna5")
    dev = DeviceIndex.from_host(host, device="cpu")
    assert dev.lut_j == pick_lut_j(host.n) and dev.lut.shape == (2 << (2 * dev.lut_j),)
    np.testing.assert_array_equal(dev.occ16[:, :12].numpy(), host.occ)
    assert not dev.occ16[:, 12:].any()
    np.testing.assert_array_equal(dev.sa_full.numpy(), host.sa_abs)
    assert DeviceIndex.from_host(host, device="cpu", full_sa=False).sa_full is None


def test_text4_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000):
        t = rng.integers(0, 16, n).astype(np.uint8)
        np.testing.assert_array_equal(pack_text4(t), jax_pack_text4(t))
        np.testing.assert_array_equal(unpack_text4(pack_text4(t), n), t)


def test_from_host_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    host = build.build_fmindex(_seqs(7), 6, "d_dna5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceIndex.from_host(host)


def test_from_host_refuses_2g_texts():
    host = build.build_fmindex(_seqs(8), 6, "d_dna5")
    host.n = 2**31
    with pytest.raises(ValueError, match="2\\^31"):
        DeviceIndex.from_host(host, device="cpu")

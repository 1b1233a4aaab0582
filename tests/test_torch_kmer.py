"""sahara_tpu_torch's kmer layer against sahara_tpu's on the CPU: XXH64, the
sketch functions, AdaptiveKmerIndex's search in every sigma bucket (exact
search and locate in kmer space, K6 and K7 through their plain versions)
and the ``.kmer.idx`` container, each package loading the other's file.
Inputs come from seeded numpy generators; everything compares exactly."""

import numpy as np
import pytest

from sahara_tpu import adaptive_kmer_index as jax_aki
from sahara_tpu import kmer as jax_kmer
from sahara_tpu import native as jax_native
from sahara_tpu_torch import adaptive_kmer_index as aki
from sahara_tpu_torch import kmer, native
from sahara_tpu_torch.cli.kmer_cmd import dense_ids

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

VOCABS = [2, 5, 14, 30, 62, 126]  # one per sigma bucket: 3, 6, 16, 32, 64, 128


def test_xxh64_matches_jax():
    assert native.xxh64(b"") == 0xEF46DB3751D8E999
    rng = np.random.default_rng(1)
    for n in range(0, 70):  # every tail length around the 32-byte stripes
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert native.xxh64(data, seed=n) == jax_native.xxh64(data, seed=n)
    keys = rng.integers(0, 2**64, size=5000, dtype=np.uint64)
    np.testing.assert_array_equal(native.xxh64_batch_u64(keys), jax_native.xxh64_batch_u64(keys))
    np.testing.assert_array_equal(native.xxh64_batch_u64(keys, seed=7), jax_native.xxh64_batch_u64(keys, seed=7))
    assert native.xxh64_u64(int(keys[0])) == jax_native.xxh64_u64(int(keys[0]))


@pytest.mark.parametrize("fn,kw", [
    ("compact_encoding", dict(k=5, canonical=False)),
    ("compact_encoding", dict(k=7, canonical=True)),
    ("compact_encoding", dict(k=40, canonical=True)),
    ("winnowing_minimizers", dict(k=3, window=4)),
    ("winnowing_minimizers", dict(k=11, window=1)),
    ("winnowing_minimizers", dict(k=9, window=500)),
    ("mod_mers", dict(k=10, mod_exp=3)),
    ("mod_mers", dict(k=3, mod_exp=0)),
])
def test_sketch_matches_jax(fn, kw):
    rng = np.random.default_rng(2)
    ranks = rng.integers(1, 6, size=2000).astype(np.uint8)  # with N (rank 5)
    for r in (ranks, ranks[:3]):
        np.testing.assert_array_equal(getattr(kmer, fn)(r, **kw), getattr(jax_kmer, fn)(r, **kw))
    mode = {"winnowing_minimizers": "winnowing", "mod_mers": "mod"}.get(fn)
    if mode:
        opts = dict(k=kw["k"], window=kw.get("window", 1), mod_exp=kw.get("mod_exp", 4))
        np.testing.assert_array_equal(kmer.kmerize(ranks, mode=mode, **opts),
                                      jax_kmer.kmerize(ranks, mode=mode, **opts))


def test_bucket_sigma_matches_jax():
    for v in range(0, 128):
        assert aki._bucket_sigma(v) == jax_aki._bucket_sigma(v)
    with pytest.raises(aki.SaharaError):
        aki._bucket_sigma(128)


def test_dense_ids_match_the_first_appearance_loop():
    """kmer-index's vectorised dense ids against the JAX package's loop
    over every value (ids in first-appearance order across sequences)."""
    rng = np.random.default_rng(3)
    values = [rng.integers(0, 40, size=n).astype(np.uint64) * np.uint64(2**40 + 7) for n in (500, 0, 77, 1)]
    uniq: dict[int, int] = {}
    want = []
    for vals in values:
        dense = np.empty(len(vals), dtype=np.int64)
        for i, v in enumerate(vals.tolist()):
            dense[i] = uniq.setdefault(v, len(uniq) + 1)
        want.append(dense)
    got_uniq, got = dense_ids(values)
    assert list(got_uniq.items()) == list(uniq.items())
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def _kmer_text(vocab: int):
    rng = np.random.default_rng(100 + vocab)
    seqs = [rng.integers(1, vocab + 1, size=n).astype(np.int64) for n in (300, 180)]
    queries = [s[p : p + 12].copy() for s in seqs for p in (0, 37, len(s) - 12)]
    queries += [s[p : p + 2].copy() for s in seqs for p in (5, 50)]  # short: many hits in a small vocabulary
    queries += [rng.integers(1, vocab + 1, size=9) for _ in range(4)]  # random: mostly no hit
    queries.append(np.zeros(0, dtype=np.int64))  # zero-length: every row of the text
    cfg = dict(mode="winnowing", kmer_len=8, window=4, mod_exp=4, largest_value=vocab)
    return seqs, queries, cfg


@pytest.mark.parametrize("vocab", VOCABS)
def test_adaptive_index_search_matches_jax(vocab):
    seqs, queries, cfg = _kmer_text(vocab)
    idx = aki.AdaptiveKmerIndex(aki.KmerConfig(**cfg), kmer_seqs=seqs)
    want = jax_aki.AdaptiveKmerIndex(jax_aki.KmerConfig(**cfg), kmer_seqs=seqs).search(queries)
    assert idx.sigma == jax_aki._bucket_sigma(vocab) and idx.device_index("cpu").row_ints >= 2 * idx.sigma
    got = idx.search(queries, device="cpu")
    assert got == want
    assert all(got[6:10]) and len(got[-1]) == idx.host_index.n


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("vocab", [5, 30, 126])
def test_kmer_container_loads_in_both_packages(tmp_path, writer, vocab):
    """A .kmer.idx written by either package loads in the other: the same
    config, dense map and host index arrays, and the same hits."""
    seqs, queries, cfg = _kmer_text(vocab)
    uniq = {int(i) * 977: int(i) for i in range(1, vocab + 1)}
    path = str(tmp_path / "ref.kmer.idx")
    mod = aki if writer == "port" else jax_aki
    mod.AdaptiveKmerIndex(mod.KmerConfig(**cfg), kmer_seqs=seqs).save(path, uniq)
    port, port_uniq = aki.AdaptiveKmerIndex.load(path)
    jax, jax_uniq = jax_aki.AdaptiveKmerIndex.load(path)
    assert port_uniq == jax_uniq == uniq and list(port_uniq) == list(uniq)
    assert vars(port.config) == vars(jax.config) == cfg
    for name in ("occ", "c_arr", "sampled", "sample_seq", "sample_pos", "seq_lens", "text4", "sa_abs"):
        a, b = getattr(port.host_index, name), getattr(jax.host_index, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert port.search(queries, device="cpu") == jax.search(queries)

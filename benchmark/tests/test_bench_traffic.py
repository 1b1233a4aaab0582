"""The read generator against the program's simulator's semantics, and its
determinism from the seed."""

import re

import numpy as np
import pytest

from benchmark import genome, harness, reads, reference
from sahara_tpu_torch.sim.read_simulator import simulate_reads
from sahara_tpu_torch.sim.workload import make_reference as program_make_reference

MIX = dict(read_length=100, errors=2, mapped_fraction=1.0, batch_reads=64, pool_batches=3)


@pytest.fixture(scope="module")
def text():
    return genome.make_reference(np.random.default_rng(1234), 30_000)


def test_text_is_the_programs_reference_model(text):
    np.testing.assert_array_equal(text, program_make_reference(np.random.default_rng(1234), 30_000))
    cfg = {"genome": {"model": "segmental_duplications", "length": 30_000, "seed": 1234, "repeat_frac": 0.35,
                      "divergence": 0.015}, "index": {}}
    np.testing.assert_array_equal(genome.make_text(cfg["genome"]), text)


def walk(trans: str, text: np.ndarray, pos: int) -> tuple[list, int]:
    """(each read char's op and the text char it stands for, the span's
    end), walking a transcript from ``pos``."""
    out, at = [], pos
    for op in trans:
        if op in "MS":
            out.append((op, int(text[at])))
        elif op == "I":
            out.append((op, None))
        at += op in "MSD"
    return out, at


def test_each_read_follows_its_transcript(text):
    n, m, e = 3000, 100, 2
    got, pos, edits = reads.simulate(text, n, m, e, np.random.default_rng(3))
    assert got.shape == (n, m) and got.dtype == np.uint8 and ((got >= 1) & (got <= 4)).all()
    for r in range(n):
        trans = reads.transcript(edits, r, m)
        assert len(trans) - trans.count("M") == e
        walked, end = walk(trans, text, int(pos[r]))
        assert 0 <= pos[r] and end <= len(text) and len(walked) == m
        for (op, ch), c in zip(walked, got[r]):
            if op == "M":
                assert c == ch
            elif op == "S":
                assert c != ch


def program_kinds(n: int, seed: int) -> list[str]:
    text = program_make_reference(np.random.default_rng(1), 20_000)
    recs = simulate_reads([np.frombuffer(b"\x00ACGT", np.uint8)[text].tobytes()], num_reads=n, read_length=100,
                          random_errors=2, seed=seed)
    return [re.search(r"trans:(\w+)", r.id).group(1) for r in recs]


def test_edit_kinds_and_slots_as_the_programs_simulator(text):
    n = 4000
    edits = reads.simulate(text, n, 100, 2, np.random.default_rng(5))[2]
    ours = [reads.transcript(edits, r, 100) for r in range(n)]
    theirs = program_kinds(n, 5)
    for trans in (ours, theirs):
        n_del = np.array([t.count("D") for t in trans])
        n_ins = np.array([t.count("I") for t in trans])
        # each edit's kind uniform: 0, 1, 2 deletions with 4/9, 4/9, 1/9
        for k, p in ((0, 4 / 9), (1, 4 / 9), (2, 1 / 9)):
            assert abs((n_del == k).mean() - p) < 0.035
            assert abs((n_ins == k).mean() - p) < 0.035
        # edits sit uniformly along the transcript
        where = np.concatenate([[i / (len(t) - 1) for i, c in enumerate(t) if c != "M"] for t in trans])
        assert abs(where.mean() - 0.5) < 0.02
        assert abs((where < 0.1).mean() - 0.1) < 0.02


def test_positions_are_uniform(text):
    pos = reads.simulate(text, 4000, 100, 2, np.random.default_rng(8))[1]
    frac = pos / (len(text) - 100)
    assert abs(frac.mean() - 0.5) < 0.02
    assert np.histogram(frac, bins=10, range=(0, 1))[0].min() > 300


def test_pool_is_the_seeds(text):
    seed = 2**31 + 123
    a = reads.make_pool(text, MIX, seed)
    b = reads.make_pool(text, MIX, seed)
    assert len(a) == MIX["pool_batches"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = reads.make_pool(text, MIX, seed + 1)
    assert not np.array_equal(a[0], c[0])
    d = reads.make_pool(text, MIX, -seed)
    assert not np.array_equal(a[0], d[0])
    assert not np.array_equal(a[0], a[1])


def test_strands_are_reverse_complements(text):
    batch = reads.make_pool(text, MIX, 7)[0]
    assert batch.shape == (2 * MIX["batch_reads"], MIX["read_length"])
    comp = np.array([0, 4, 3, 2, 1], dtype=np.uint8)
    np.testing.assert_array_equal(batch[1::2], comp[batch[0::2][:, ::-1]])


def test_hostdep_maps_a_fixed_share(text):
    mix = dict(MIX, mapped_fraction=0.25, batch_reads=80)
    tab = reference.Text([text], reference.g_for(100, 2), "cpu")
    for batch in reads.make_pool(text, mix, 11):
        rows = reference.hits(tab, batch, 2)
        # uniform random reads match nowhere within 2 edits; a mapped read on one strand at least
        assert len(np.unique(rows["query"] // 2)) == 20


@pytest.mark.parametrize("name", ["mapped", "hostdep"])
def test_a_batch_is_one_block_of_the_search_command(tmp_path, name):
    """``batch_reads`` is what the program's FASTA stream hands one search:
    the records of one 64 MiB block, here read at a smaller block size."""
    from sahara_tpu_torch.io.fasta import iter_fasta_seq_matrix_blocks

    mix = harness.load_json(harness.HERE, "traffic", name + ".json")
    header = b">EAS139:136:FC706VJ:2:2104:15343:197393 1:Y:18:ATCACG\n"
    record = header + b"ACGT" * 25 + b"\n"
    assert mix["batch_reads"] == (64 << 20) // len(record) and str(len(record)) in mix["batch_from"]
    path = tmp_path / "reads.fa"
    path.write_bytes(record * 40)
    block = 7 * len(record) + 100
    first = next(iter_fasta_seq_matrix_blocks(str(path), block_bytes=block))
    assert first.shape == (block // len(record), mix["read_length"])

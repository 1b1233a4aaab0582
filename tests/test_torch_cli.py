"""The port's CLI (``python -m sahara_tpu_torch``) on the CPU.

The conformance corpus of ``tests/test_conformance.py`` is built through
the port's own ``write_fasta``, ``read_simulator`` and index subcommands;
the 9 ``search`` and 2 ``rbi`` goldens and the ``uni-search`` and
``kmer-search`` goldens must come out byte-identical with ``--device cpu``.
The index files (``.kmer.idx`` too), the simulated reads and the
``search_scheme`` / ``columba_prepare`` outputs are held against the JAX
package's CLI on the same inputs (its index and host-only commands compile
nothing); the kmer files each package writes are searched by the other."""

from __future__ import annotations

import contextlib
import filecmp
import functools
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from test_conformance import CASES, GOLDEN_DIR

import chip_smoke
from sahara_tpu.cli.main import main as jax_main
from sahara_tpu_torch.cli import index_cmd, search_cmd
from sahara_tpu_torch.cli.main import main
from sahara_tpu_torch.index.fmindex import FastNpz
from sahara_tpu_torch.io.fasta import FastaRecord, iter_fasta_seq_matrix_blocks, read_fasta, write_fasta

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

# chip_smoke.py's copy of the conformance corpus, which it runs on the card:
# the goldens below hold it right
READS = chip_smoke.GOLDEN_READS
RBI_CASES = chip_smoke.GOLDEN_RBI_CASES
INDEX_COMMANDS = ("index", "uni-index", "rbi-index", "rbi-index-dna4")


def _quiet(fn, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(chip_smoke.GOLDEN_SEED)
    seqs = [
        FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
        for i, n in enumerate(chip_smoke.GOLDEN_SEQ_LENS)
    ]
    ref = str(tmp / "ref.fasta")
    write_fasta(ref, seqs)
    for name, (n, length, e, seed) in READS.items():
        assert _quiet(main, ["read_simulator", "-i", ref, "-o", str(tmp / f"{name}.fasta"), "-n", str(n),
                             "-l", str(length), "-e", str(e), "--seed", str(seed)])[0] == 0
    for cmd in INDEX_COMMANDS:
        assert _quiet(main, [cmd, ref])[0] == 0
    assert _quiet(main, ["kmer-index", ref, "--kmer", "1"])[0] == 0
    return tmp, ref


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return fh.read()


def test_chip_smoke_cases_are_the_conformance_cases():
    assert chip_smoke.GOLDEN_CASES == CASES
    assert chip_smoke.GOLDEN_DIR == os.path.abspath(GOLDEN_DIR)


@pytest.mark.parametrize("name,reads,flags", CASES, ids=[c[0] for c in CASES])
def test_search_goldens(corpus, tmp_path, name, reads, flags):
    tmp, ref = corpus
    out = tmp_path / "out.txt"
    rc, _ = _quiet(main, ["search", "-q", str(tmp / f"{reads}.fasta"), "-i", ref + ".idx", "-o", str(out),
                          "--device", "cpu"] + flags)
    assert rc == 0
    assert out.read_text() == _golden(name)


@pytest.mark.parametrize("name,cmd,suffix", RBI_CASES, ids=[c[0] for c in RBI_CASES])
def test_rbi_search_goldens(corpus, tmp_path, name, cmd, suffix):
    tmp, ref = corpus
    out = tmp_path / "rbi.txt"
    rc, _ = _quiet(main, [cmd, "-q", str(tmp / "r1.fasta"), "-i", ref + suffix, "-o", str(out), "-e", "1",
                          "-g", "optimum", "--device", "cpu"])
    assert rc == 0
    assert out.read_text() == _golden(name)


EXACT_CASES = [
    ("uni_exact.txt", ["uni-search", "-q", "{reads}", "-i", "{ref}.single.idx", "-o", "{out}"]),
    ("kmer_exact.txt", ["kmer-search", "--query", "{reads}", "--index", "{ref}.kmer.idx", "--output", "{out}"]),
]


@pytest.mark.parametrize("name,argv", EXACT_CASES, ids=[c[0] for c in EXACT_CASES])
def test_exact_search_goldens(corpus, tmp_path, name, argv):
    """uni-search (exact search on the single index) and kmer-search (in
    kmer space, sigma = 3 at --kmer 1) as tests/test_conformance.py runs
    them, on the CPU."""
    tmp, ref = corpus
    out = tmp_path / "out.txt"
    fill = dict(reads=str(tmp / "r0.fasta"), ref=ref, out=str(out))
    assert _quiet(main, [a.format(**fill) for a in argv] + ["--device", "cpu"])[0] == 0
    assert out.read_text() == _golden(name)


def _masked(log: str) -> str:
    """A subcommand's stdout with its timings masked."""
    return re.sub(r" +\d+(\.\d+s|q/s)$", " T", log, flags=re.M)


KMER_MODES = {
    "winnowing": ["--kmer", "3", "--window", "4"],
    "mod": ["--kmer_mode", "mod", "--mod", "6", "--kmer", "10"],
}


@pytest.fixture(scope="module")
def kmer_corpus(tmp_path_factory):
    """A 4,000-char reference with an N, a second record of its first 1,500
    chars reversed, and 8 reads of 600 chars cut from the first (plus one
    with an unseen kmer and one too short to keep)."""
    tmp = tmp_path_factory.mktemp("kmer_cli")
    rng = np.random.default_rng(77)
    ref = bytearray(b"ACGT"[j] for j in rng.integers(0, 4, size=4000))
    ref[1234] = ord("N")
    reads = [FastaRecord(id=f"r{i}", seq=bytes(ref[p : p + 600]))
             for i, p in enumerate(rng.integers(0, len(ref) - 600, size=8))]
    reads += [FastaRecord(id="unseen", seq=b"ACGTAGCTAGNNNNNNNNNNNNNNNNNNNNNNNNNNNNN" * 4),
              FastaRecord(id="short", seq=bytes(ref[100:112]))]
    write_fasta(tmp / "reads.fasta", reads)
    return tmp, [FastaRecord(id="chr1", seq=bytes(ref)), FastaRecord(id="chr2", seq=bytes(ref[:1500][::-1]))]


@pytest.mark.parametrize("mode", KMER_MODES)
def test_kmer_index_and_search_match_jax(kmer_corpus, tmp_path, mode):
    """kmer-index through each package: the same stdout (timings masked)
    and the same container, the inner index array by array; then
    kmer-search of each package on the other's file: the same stdout and
    byte-identical hits."""
    tmp, recs = kmer_corpus
    logs, paths = {}, {}
    for side, fn in (("port", main), ("jax", jax_main)):
        os.makedirs(tmp_path / side)
        ref = str(tmp_path / side / "ref.fasta")
        write_fasta(ref, recs)
        rc, log = _quiet(fn, ["kmer-index", ref] + KMER_MODES[mode])
        assert rc == 0
        logs[side], paths[side] = _masked(log).replace(str(tmp_path / side), ""), ref + ".kmer.idx"
    assert logs["port"] == logs["jax"]
    got, want = _idx_members(paths["port"]), _idx_members(paths["jax"])
    assert sorted(got) == sorted(want) == ["inner_index", "kmer_meta", "uniq_keys", "uniq_vals"]
    for name in ("kmer_meta", "uniq_keys", "uniq_vals"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    inner = [_idx_members(io.BytesIO(bytes(m["inner_index"]))) for m in (got, want)]
    assert inner[0]["meta"] == inner[1]["meta"] and sorted(inner[0]) == sorted(inner[1])
    for name in inner[1]:
        if name != "meta":
            np.testing.assert_array_equal(inner[0][name], inner[1][name], err_msg=name)
    outs = {}
    for side, fn, index, extra in (("port", main, paths["jax"], ["--device", "cpu"]),
                                   ("jax", jax_main, paths["port"], [])):
        outs[side] = tmp_path / side / "hits.txt"
        rc, log = _quiet(fn, ["kmer-search", "--query", str(tmp / "reads.fasta"), "--index", index,
                              "--output", str(outs[side])] + extra)
        assert rc == 0
        logs[side] = re.sub(r"/(port|jax)/", "/", _masked(log).replace(str(tmp_path), ""))
    assert logs["port"] == logs["jax"] and "skipped" in logs["port"]
    assert outs["port"].read_text() == outs["jax"].read_text() and outs["port"].read_text()


def test_exact_commands_without_card_raise(corpus, tmp_path, monkeypatch):
    """uni-search and kmer-search default to the card; without one they
    raise before they read anything."""
    tmp, ref = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["uni-search", "-q", str(tmp / "r0.fasta"), "-i", ref + ".single.idx", "-o"],
                 ["kmer-search", "--query", str(tmp / "r0.fasta"), "--index", ref + ".kmer.idx", "--output"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(main, argv + [str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()


def test_rbi_orig_coords_maps_mirror_hits(corpus, tmp_path):
    """A reverse-complement read hits a mirror copy (seqId in [m, 2m));
    ``--orig_coords`` moves each such hit to its original sequence at
    L - 1 - pos and leaves forward hits alone."""
    tmp, ref = corpus
    chroms = [r.seq for r in read_fasta(ref)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    recs = []
    for i, seq in enumerate(chroms):
        fwd = seq[40 * i + 30 : 40 * i + 70]
        recs += [FastaRecord(id=f"f{i}", seq=fwd), FastaRecord(id=f"r{i}", seq=fwd.translate(comp)[::-1])]
    reads = tmp_path / "strands.fasta"
    write_fasta(reads, recs)
    runs = {}
    for flags in ([], ["--orig_coords"]):
        out = tmp_path / f"rbi{len(flags)}.txt"
        assert _quiet(main, ["rbi-search", "-q", str(reads), "-i", ref + ".rbi.idx", "-o", str(out), "-e", "1",
                             "-g", "optimum", "--device", "cpu"] + flags)[0] == 0
        runs[len(flags)] = [tuple(map(int, ln.split())) for ln in out.read_text().splitlines()]
    m = len(chroms)
    for i, seq in enumerate(chroms):
        assert (2 * i, i, 40 * i + 30) in runs[0]
        assert (2 * i + 1, m + i, len(seq) - (40 * i + 70)) in runs[0]
        assert (2 * i + 1, i, 40 * i + 69) in runs[1]
    lens = [len(seq) for seq in chroms]
    want = sorted({(q, s - m, lens[s - m] - 1 - p) if s >= m else (q, s, p) for q, s, p in runs[0]})
    assert sorted(set(runs[1])) == want and len(runs[1]) == len(want)


def test_read_simulator_matches_jax(corpus, tmp_path):
    tmp, ref = corpus
    for name, (n, length, e, seed) in READS.items():
        want = tmp_path / f"{name}.fasta"
        assert _quiet(jax_main, ["read_simulator", "-i", ref, "-o", str(want), "-n", str(n), "-l", str(length),
                                 "-e", str(e), "--seed", str(seed)])[0] == 0
        assert filecmp.cmp(tmp / f"{name}.fasta", want, shallow=False)
    # no reference: uniformly random reads
    for fn, out in ((main, tmp_path / "a.fasta"), (jax_main, tmp_path / "b.fasta")):
        assert _quiet(fn, ["read_simulator", "-o", str(out), "-n", "7", "-l", "33", "--seed", "4"])[0] == 0
    assert filecmp.cmp(tmp_path / "a.fasta", tmp_path / "b.fasta", shallow=False)


def _idx_members(path) -> dict:
    with FastNpz(path) as data:
        members = {name: np.array(data[name]) for name in data.files}
    if "meta" in members:
        members["meta"] = json.loads(bytes(members["meta"]).decode())
    return members


@pytest.mark.parametrize("cmd,flags,suffix", [
    ("index", ["--ignore_unknown"], ".idx"),
    ("index", ["--dna4", "--ignore_unknown"], ".dna4.idx"),
    ("uni-index", ["--ignore_unknown"], ".single.idx"),
    ("rbi-index", ["--ignore_unknown"], ".rbi.idx"),
    ("rbi-index-dna4", ["--ignore_unknown"], ".rbi4.idx"),
])
def test_index_files_match_jax(tmp_path, cmd, flags, suffix):
    """Each index subcommand writes the JAX package's container (meta and
    every array) on a FASTA with IUPAC codes and N, which the unknown-char
    policies replace (N, random ACGT, random rank 1/2)."""
    rng = np.random.default_rng(3)
    recs = [FastaRecord(id=f"s{i}", seq=bytes(rng.choice(list(b"ACGTNacgtRYW"), size=n)))
            for i, n in enumerate((300, 90, 170))]
    paths = {}
    for side, fn in (("port", main), ("jax", jax_main)):
        os.makedirs(tmp_path / side)
        ref = str(tmp_path / side / "ref.fasta")
        write_fasta(ref, recs)
        assert _quiet(fn, [cmd, ref] + flags)[0] == 0
        paths[side] = ref + suffix
    got, want = _idx_members(paths["port"]), _idx_members(paths["jax"])
    assert got["meta"] == want["meta"]
    assert sorted(got) == sorted(want)
    for name in want:
        if name != "meta":
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert ("occ_rev" in got) == (cmd == "index")


@pytest.fixture(scope="module")
def two_line_reads(corpus):
    """300 reads of 50 chars, one sequence line each (a simple FASTA)."""
    tmp, ref = corpus
    reads = str(tmp / "reads2.fasta")
    assert _quiet(main, ["read_simulator", "-i", ref, "-o", reads, "-n", "300", "-l", "50", "-e", "1",
                         "--seed", "21", "--fasta_line_length", "0"])[0] == 0
    return reads


@pytest.mark.parametrize("extra", [[], ["-m", "besthits"], ["--limit_queries", "101"], ["--no-reverse"]])
def test_stream_matches_buffered(corpus, two_line_reads, tmp_path, monkeypatch, extra):
    tmp, ref = corpus
    base = ["search", "-q", two_line_reads, "-i", ref + ".idx", "-e", "1", "-g", "optimum", "--device", "cpu"] + extra
    monkeypatch.setenv("SAHARA_STREAM", "0")
    rc, log = _quiet(main, base + ["-o", str(tmp_path / "buf.txt")])
    assert rc == 0 and "streaming" not in log
    monkeypatch.setenv("SAHARA_STREAM", "1")
    # small blocks so that several flow through the threads
    monkeypatch.setattr(search_cmd, "iter_fasta_seq_matrix_blocks",
                        functools.partial(iter_fasta_seq_matrix_blocks, block_bytes=4096))
    rc, log = _quiet(main, base + ["-o", str(tmp_path / "str.txt")])
    assert rc == 0 and "streaming:           True" in log
    assert (tmp_path / "str.txt").read_text() == (tmp_path / "buf.txt").read_text()
    assert (tmp_path / "buf.txt").read_text().strip()


def test_stream_thread_errors_reach_main(corpus, two_line_reads, tmp_path, monkeypatch):
    """A bad character in a later block (reader thread) exits 1 with the
    message; an output that cannot be opened (writer thread) raises."""
    tmp, ref = corpus
    monkeypatch.setenv("SAHARA_STREAM", "1")
    monkeypatch.setattr(search_cmd, "iter_fasta_seq_matrix_blocks",
                        functools.partial(iter_fasta_seq_matrix_blocks, block_bytes=4096))
    text = open(two_line_reads).read().splitlines()
    text[-1] = "X" + text[-1][1:]
    bad = tmp_path / "bad.fasta"
    bad.write_text("\n".join(text) + "\n")
    base = ["search", "-i", ref + ".idx", "-e", "1", "--device", "cpu"]
    rc, _ = _quiet(main, base + ["-q", str(bad), "-o", str(tmp_path / "o.txt")])
    assert rc == 1
    with pytest.raises(FileNotFoundError):
        _quiet(main, base + ["-q", two_line_reads, "-o", str(tmp_path / "missing" / "o.txt")])


def test_stream_declines_wrapped_fasta(corpus, tmp_path, monkeypatch):
    """A read file with wrapped lines is not simple: the buffered path runs."""
    tmp, ref = corpus
    reads = tmp_path / "wrapped.fasta"
    assert _quiet(main, ["read_simulator", "-i", ref, "-o", str(reads), "-n", "20", "-l", "100", "-e", "1"])[0] == 0
    monkeypatch.setenv("SAHARA_STREAM", "1")
    rc, log = _quiet(main, ["search", "-q", str(reads), "-i", ref + ".idx", "-o", str(tmp_path / "o.txt"), "-e", "1",
                            "--device", "cpu"])
    assert rc == 0 and "streaming" not in log and "engine: seed-verify" in log


def test_stream_falls_back_on_a_later_ragged_record(corpus, two_line_reads, tmp_path, monkeypatch):
    """A record of another length after the first block stops the stream;
    the buffered path re-runs the whole file and writes its output."""
    tmp, ref = corpus
    reads = tmp_path / "ragged.fasta"
    with open(two_line_reads) as fh:
        reads.write_text(fh.read() + ">short\n" + "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTA\n")
    base = ["search", "-q", str(reads), "-i", ref + ".idx", "-e", "1", "--device", "cpu"]
    monkeypatch.setenv("SAHARA_STREAM", "0")
    assert _quiet(main, base + ["-o", str(tmp_path / "buf.txt")])[0] == 0
    monkeypatch.setenv("SAHARA_STREAM", "1")
    monkeypatch.setattr(search_cmd, "iter_fasta_seq_matrix_blocks",
                        functools.partial(iter_fasta_seq_matrix_blocks, block_bytes=4096))
    rc, log = _quiet(main, base + ["-o", str(tmp_path / "str.txt")])
    assert rc == 0 and "streaming:           True" in log and log.count("config:") == 2
    assert (tmp_path / "str.txt").read_text() == (tmp_path / "buf.txt").read_text()


@pytest.mark.parametrize("name,engine", [("e2_lev_h2k2.txt", "auto"), ("e2_lev_maxhits2.txt", "workq")])
def test_search_devices_matches_jax_and_goldens(corpus, tmp_path, name, engine):
    """``--devices 2 --device cpu``: a mesh of two CPU entries, seed-and-verify
    or the work-queue engine on each slice; the output is the golden's and,
    through seed-and-verify, sahara_tpu's ``--devices 2`` output (its mesh
    of two virtual CPU devices)."""
    tmp, ref = corpus
    reads, flags = next((r, f) for n, r, f in CASES if n == name)
    argv = ["search", "-q", str(tmp / f"{reads}.fasta"), "-i", ref + ".idx", "--devices", "2"] + flags
    out = tmp_path / "out.txt"
    rc, log = _quiet(main, argv + ["-o", str(out), "--device", "cpu", "--engine", engine])
    assert rc == 0 and out.read_text() == _golden(name)
    assert "devices:             2" in log and f"engine: {'seed-verify' if engine == 'auto' else 'workq'} (mesh[2]" in log
    if engine == "auto":
        assert _quiet(jax_main, argv + ["-o", str(tmp_path / "jax.txt")])[0] == 0
        assert (tmp_path / "jax.txt").read_text() == out.read_text()


def test_stream_on_a_mesh_matches_buffered(corpus, two_line_reads, tmp_path, monkeypatch):
    """The streaming path searches its blocks over the mesh too."""
    tmp, ref = corpus
    base = ["search", "-q", two_line_reads, "-i", ref + ".idx", "-e", "1", "--device", "cpu", "--devices", "3"]
    monkeypatch.setenv("SAHARA_STREAM", "1")
    monkeypatch.setattr(search_cmd, "iter_fasta_seq_matrix_blocks",
                        functools.partial(iter_fasta_seq_matrix_blocks, block_bytes=4096))
    rc, log = _quiet(main, base + ["-o", str(tmp_path / "str.txt")])
    assert rc == 0 and "streaming:           True" in log and "devices:             3" in log
    monkeypatch.setenv("SAHARA_STREAM", "0")
    assert _quiet(main, base[:-2] + ["-o", str(tmp_path / "buf.txt")])[0] == 0
    assert (tmp_path / "str.txt").read_text() == (tmp_path / "buf.txt").read_text()


@pytest.mark.parametrize("name,cmd,suffix", RBI_CASES, ids=[c[0] for c in RBI_CASES])
def test_rbi_search_devices_matches_one_device(corpus, tmp_path, name, cmd, suffix):
    tmp, ref = corpus
    argv = [cmd, "-q", str(tmp / "r1.fasta"), "-i", ref + suffix, "-e", "1", "-g", "optimum", "--device", "cpu"]
    rc, log = _quiet(main, argv + ["-o", str(tmp_path / "mesh.txt"), "--devices", "4"])
    assert rc == 0 and "devices:             4" in log and "mesh[4]" in log
    assert _quiet(main, argv + ["-o", str(tmp_path / "one.txt")])[0] == 0
    assert (tmp_path / "mesh.txt").read_text() == (tmp_path / "one.txt").read_text() == _golden(name)


SHARD_MB = "0.0008"  # 800 chars a shard: the corpus's 700-char record alone, then the two others


@pytest.fixture(scope="module")
def sharded_corpus(corpus, tmp_path_factory):
    """The corpus's reference indexed with --max_shard_mb by each package's
    CLI, each in its own directory."""
    _, ref = corpus
    out = {}
    for side, fn in (("port", main), ("jax", jax_main)):
        d = tmp_path_factory.mktemp(f"sharded_{side}")
        out[side] = str(d / "ref.fasta")
        with open(ref, "rb") as src, open(out[side], "wb") as dst:
            dst.write(src.read())
        rc, log = _quiet(fn, ["index", out[side], "--max_shard_mb", SHARD_MB])
        assert rc == 0 and "  shards: 2" in log
    return out


def test_sharded_index_file_equals_jax(sharded_corpus):
    assert filecmp.cmp(sharded_corpus["port"] + ".idx", sharded_corpus["jax"] + ".idx", shallow=False)


@pytest.mark.parametrize("name,reads,flags", [c for c in CASES if c[0] in ("e1_lev_optimum.txt", "e2_ham_pigeonopt.txt")],
                         ids=["e1_lev_optimum", "e2_ham_pigeonopt"])
def test_search_on_sharded_index_equals_jax(corpus, sharded_corpus, tmp_path, name, reads, flags):
    """``search`` on the sharded container: the port's output equals the JAX
    CLI's on it, and both the golden of the unsharded index."""
    tmp, _ = corpus
    outs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        outs.append(tmp_path / f"out{len(outs)}.txt")
        rc, log = _quiet(fn, ["search", "-q", str(tmp / f"{reads}.fasta"), "-i", sharded_corpus["port"] + ".idx",
                              "-o", str(outs[-1])] + flags + extra)
        assert rc == 0 and "shard 2/2" in log
    assert outs[0].read_text() == outs[1].read_text() == _golden(name)


def test_index_shards_by_itself_from_the_text_limit(corpus, sharded_corpus, tmp_path, monkeypatch):
    """A text of SHARD_TEXT_CHARS characters or more takes the sharded
    container without --max_shard_mb (limit and shard budget patched small:
    the file then equals the --max_shard_mb one)."""
    _, ref = corpus
    monkeypatch.setattr(index_cmd, "SHARD_TEXT_CHARS", 1000)
    monkeypatch.setattr(index_cmd, "DEFAULT_MAX_CHARS", int(float(SHARD_MB) * 1_000_000))
    local = tmp_path / "ref.fasta"
    local.write_bytes(open(ref, "rb").read())
    rc, log = _quiet(main, ["index", str(local)])
    assert rc == 0 and "  shards: 2" in log
    assert filecmp.cmp(str(local) + ".idx", sharded_corpus["jax"] + ".idx", shallow=False)


@pytest.mark.parametrize("name,reads,flags", [c for c in CASES if c[0] in ("e1_lev_optimum.txt", "e2_lev_besthits.txt")],
                         ids=["e1_lev_optimum", "e2_lev_besthits"])
def test_search_engine_approx_equals_jax(corpus, tmp_path, name, reads, flags):
    """``--engine approx`` on a golden's inputs: the port's output equals the
    JAX CLI's, and the golden."""
    tmp, ref = corpus
    outs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        outs.append(tmp_path / f"out{len(outs)}.txt")
        rc, log = _quiet(fn, ["search", "-q", str(tmp / f"{reads}.fasta"), "-i", ref + ".idx", "-o", str(outs[-1]),
                              "--engine", "approx"] + flags + extra)
        assert rc == 0 and "engine: approx" in log
    assert outs[0].read_text() == outs[1].read_text() == _golden(name)


def test_search_without_card_raises(corpus, tmp_path, monkeypatch):
    """``--device`` defaults to the card; without one the search raises
    before it reads anything, and never carries on on the CPU."""
    tmp, ref = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["search", "-i", ref + ".idx"], ["rbi-search", "-i", ref + ".rbi.idx"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(main, argv + ["-q", str(tmp / "r1.fasta"), "-o", str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()


def test_search_config_and_stats_match_jax_words(corpus, tmp_path):
    """The config echo, the driver's lines and the stats block's keys are
    the JAX package's, word for word (times masked)."""
    tmp, ref = corpus
    logs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        rc, log = _quiet(fn, ["search", "-q", str(tmp / "r2.fasta"), "-i", ref + ".idx", "-o", str(tmp_path / "o.txt"),
                              "-e", "2", "-g", "h2-k2", "--dynamic_generator", "--engine", "workq"] + extra)
        assert rc == 0
        logs.append(_masked(log))
    assert logs[0] == logs[1]
    assert "partition: [" in logs[0] and "weighted node count:" in logs[0]


SCHEME_CASES = [
    ["-g", "optimum", "-k", "2"],
    ["-g", "pigeon", "-k", "1", "-l", "60"],
    ["list-generators"],
    ["-a", "-k", "1", "-l", "40"],
    ["-a", "-y", "-k", "1"],
    ["-a", "--columba", "{dir}/columba", "-k", "2"],
    ["-g", "optimum", "-k", "1", "--tikz", "{dir}/tree"],
    ["-g", "h2-k2", "-k", "2", "--tikz", "{dir}/tree", "--expansion_mode", "topdown", "-l", "50"],
]


@pytest.mark.parametrize("args", SCHEME_CASES, ids=[" ".join(a) for a in SCHEME_CASES])
def test_search_scheme_matches_jax(tmp_path, args):
    outs = {}
    for side, fn in (("port", main), ("jax", jax_main)):
        os.makedirs(tmp_path / side)
        rc, log = _quiet(fn, ["search_scheme"] + [a.format(dir=tmp_path / side) for a in args])
        assert rc == 0
        outs[side] = log
    assert outs["port"] == outs["jax"]
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.left_only and not cmp.right_only
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            want = os.path.join(root, f)
            got = want.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            assert filecmp.cmp(got, want, shallow=False), f


def test_columba_prepare_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    recs = [FastaRecord(id=f"s{i}", seq=bytes(rng.choice(list(b"ACGTNacgu"), size=n)))
            for i, n in enumerate((400, 150))]
    ref = tmp_path / "ref.fasta"
    write_fasta(ref, recs)
    logs = {}
    for side, fn in (("port", main), ("jax", jax_main)):
        rc, log = _quiet(fn, ["columba_prepare", "-i", str(ref), "-o", str(tmp_path / side)])
        assert rc == 0
        logs[side] = log.replace(side, "BASE")
    assert logs["port"] == logs["jax"]
    for ext in (".txt", ".sa", ".rev.txt", ".rev.sa"):
        assert filecmp.cmp(tmp_path / f"port{ext}", tmp_path / f"jax{ext}", shallow=False), ext

"""The read generator: a pool of batches of reads from ``--seed``, as a
traffic mix's parameters describe them.

``simulate`` is the read simulator of the program's ``sim/read_simulator.py``
(``simulate_reads`` with ``random_errors``) vectorised over reads, with the
same semantics but not the same random stream:

- each of the ``errors`` edits is a substitution, an insertion or a
  deletion, uniformly;
- the transcript starts as ``read_length`` matches; substitutions and
  insertions replace distinct matches, and deletions are inserted at
  uniform positions (so their slots are uniform among the final ones);
- the reference span is ``read_length`` + #D - #I chars at a uniform
  position that does not overrun the text;
- a substituted char differs from the original; an inserted one is
  uniform.

A traffic mix: ``read_length``, ``errors``, ``batch_reads``,
``pool_batches`` and ``mapped_fraction``, the share of each batch's reads
simulated from the text; the rest are uniform random ACGT.  Every batch
holds the same number of mapped reads, at positions drawn from the seed.
Every mix is sent by one client in a closed loop, and each read is searched
on both strands: rows 2i and 2i+1 of a batch are read i and its reverse
complement, as the program's command line lays them out.
"""

from __future__ import annotations

import numpy as np

S, I, D = 1, 2, 3  # edit kinds
COMPLEMENT = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint8)  # $ A C G T N -> $ T G C A N


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of one ``--seed`` (any whole
    number, negative ones included)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def distinct_slots(rng: np.random.Generator, size: np.ndarray, count: np.ndarray, kmax: int) -> np.ndarray:
    """int64[n, kmax]: ``count[r]`` distinct uniform slots of ``range(size[r])``
    in row r, the rest -1."""
    n = len(size)
    out = np.full((n, kmax), -1, dtype=np.int64)
    for e in range(kmax):
        x = np.floor(rng.random(n) * np.maximum(size - e, 1)).astype(np.int64)
        # the x-th slot not yet taken: step over the taken ones in ascending order
        taken = np.sort(np.where(out[:, :e] < 0, np.iinfo(np.int64).max, out[:, :e]), axis=1)
        for c in range(e):
            x += x >= taken[:, c]
        out[:, e] = np.where(e < count, x, -1)
    return out


def simulate(text: np.ndarray, n_reads: int, read_len: int, errors: int, rng: np.random.Generator):
    """(reads uint8[n, read_len], pos int64[n], edits): reads simulated from
    ``text`` (ranks 1-4) with exactly ``errors`` edits, and their span's
    start.  ``edits`` = (kind int64[n, errors] of S, I, D; ``si``, the read
    positions of the S and I edits, S first; ``dslot``, the deletions'
    slots in the final transcript), -1 where unused; ``transcript`` spells
    one read's out."""
    n = n_reads
    kind = rng.integers(S, D + 1, size=(n, errors))
    n_sub, n_ins, n_del = ((kind == t).sum(axis=1) for t in (S, I, D))
    # S, then I, at distinct read positions; deletions at distinct slots of
    # the final transcript of read_len + n_del ops
    si = distinct_slots(rng, np.full(n, read_len), n_sub + n_ins, errors)
    dslot = np.sort(distinct_slots(rng, read_len + n_del, n_del, errors), axis=1)
    span = read_len + n_del - n_ins
    pos = np.floor(rng.random(n) * (len(text) - span + 1)).astype(np.int64)
    # read position o takes text[pos + o + #D before it - #I before it]
    o = np.arange(read_len, dtype=np.int32)[None, :]
    at = np.broadcast_to(pos[:, None].astype(np.int32), (n, read_len)) + o
    col = np.arange(errors)[None, :]
    is_ins = (col >= n_sub[:, None]) & (si >= 0)
    for e in range(errors):
        d_at = np.where(dslot[:, e] >= 0, dslot[:, e] - (dslot[:, :e] >= 0).sum(axis=1), read_len + 1)
        at = at + (o >= d_at[:, None].astype(np.int32))
        i_at = np.where(is_ins[:, e], si[:, e], read_len + 1)
        at = at - (o > i_at[:, None].astype(np.int32))
    reads = text[np.minimum(at, len(text) - 1)]
    rows = np.arange(n)[:, None].repeat(errors, axis=1)
    sub = (si >= 0) & ~is_ins
    old = reads[rows[sub], si[sub]]
    reads[rows[sub], si[sub]] = (old - 1 + rng.integers(1, 4, size=old.shape, dtype=np.uint8)) % 4 + 1
    reads[rows[is_ins], si[is_ins]] = rng.integers(1, 5, size=int(is_ins.sum()), dtype=np.uint8)
    return reads, pos, (kind, si, dslot)


def transcript(edits, r: int, read_len: int) -> str:
    """Read r's edit transcript over ``M``, ``S``, ``I``, ``D``."""
    kind, si, dslot = (a[r] for a in edits)
    n_sub = int((kind == S).sum())
    ops = ["M"] * read_len
    for e, p in enumerate(si):
        if p >= 0:
            ops[p] = "S" if e < n_sub else "I"
    for t in sorted(int(t) for t in dslot if t >= 0):
        ops.insert(t, "D")
    return "".join(ops)


def both_strands(reads: np.ndarray) -> np.ndarray:
    """uint8[2n, m]: each read followed by its reverse complement."""
    out = np.empty((2 * reads.shape[0], reads.shape[1]), dtype=np.uint8)
    out[0::2] = reads
    out[1::2] = COMPLEMENT[reads[:, ::-1]]
    return out


def make_batch(text: np.ndarray, traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """One batch of strand queries, uint8[2 * batch_reads, read_length]."""
    n, m = traffic["batch_reads"], traffic["read_length"]
    n_mapped = round(traffic["mapped_fraction"] * n)
    reads = rng.integers(1, 5, size=(n, m), dtype=np.uint8)
    at = rng.permutation(n)[:n_mapped]
    reads[at] = simulate(text, n_mapped, m, traffic["errors"], rng)[0]
    return both_strands(reads)


def make_pool(text: np.ndarray, traffic: dict, seed: int) -> list[np.ndarray]:
    """``pool_batches`` batches, the same for the same ``seed``."""
    rng = rng_of(seed, 0)
    return [make_batch(text, traffic, rng) for _ in range(traffic["pool_batches"])]

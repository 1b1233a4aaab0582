"""Read simulator: sample reads from a reference and plant an exact number
of substitution/insertion/deletion errors via an explicit edit transcript.

A copy of ``sahara_tpu/sim/read_simulator.py::simulate_reads``: for the same
seed it gives the same reads, so a workload made here equals the JAX
package's.

- the transcript starts as ``M`` * read_length; substitutions and insertions
  replace a random ``M`` (the read length stays read_length); deletions are
  inserted at a random position;
- the reference span length is read_length + #D - #I;
- non-ACGT reference characters are replaced by random ACGT on load;
- a substituted character always differs from the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sahara_tpu_torch.alphabet import INVALID_RANK, dna4_char_to_rank, dna4_rank_to_char

_ACGT = b"ACGT"


@dataclasses.dataclass
class FastaRecord:
    id: str
    seq: bytes


@dataclasses.dataclass
class Transcript:
    """Edit transcript: a string over M/S/I/D."""

    ops: str

    @staticmethod
    def generate(rng: np.random.Generator, length: int, sub: int = 0, ins: int = 0, dele: int = 0) -> "Transcript":
        ops = ["M"] * length
        matches = length

        def replace_match(op: str):
            nonlocal matches
            if matches == 0:
                raise RuntimeError("no more matches for this transcript possible")
            pos = int(rng.integers(0, len(ops)))
            while ops[pos] != "M":
                pos = int(rng.integers(0, len(ops)))
            ops[pos] = op
            matches -= 1

        for _ in range(sub):
            replace_match("S")
        for _ in range(ins):
            replace_match("I")
        for _ in range(dele):
            pos = int(rng.integers(0, len(ops) + 1))
            ops.insert(pos, "D")
        return Transcript("".join(ops))

    @property
    def length_of_ref(self) -> int:
        """Length of the reference span this transcript consumes."""
        return len(self.ops) - self.ops.count("I")

    def apply(self, span: bytes, rng: np.random.Generator) -> bytes:
        """Mutate a reference span into a read."""
        out = bytearray()
        p = 0
        for t in self.ops:
            if t == "M":
                out.append(span[p])
                p += 1
            elif t == "S":
                r = int(rng.integers(0, 3))
                rank = int(dna4_char_to_rank(bytes([span[p]]))[0])
                out += dna4_rank_to_char(np.array([(rank + r + 1) % 4]))
                p += 1
            elif t == "I":
                out.append(_ACGT[int(rng.integers(0, 4))])
            elif t == "D":
                p += 1
            else:
                raise ValueError(f'Invalid transcript "{t}"')
        return bytes(out)


def normalize_reference(seq: bytes, rng: np.random.Generator) -> bytes:
    """Uppercase-normalize; replace non-ACGT with random ACGT."""
    ranks = dna4_char_to_rank(seq)
    bad = ranks == INVALID_RANK
    out = np.frombuffer(dna4_rank_to_char(np.where(bad, 0, ranks)), dtype=np.uint8).copy()
    n_bad = int(bad.sum())
    if n_bad:
        out[bad] = np.frombuffer(_ACGT, dtype=np.uint8)[rng.integers(0, 4, size=n_bad)]
    return out.tobytes()


def simulate_reads(
    sequences: list[bytes],
    *,
    num_reads: int = 1000,
    read_length: int = 150,
    sub_errors: int = 0,
    ins_errors: int = 0,
    del_errors: int = 0,
    random_errors: int = 0,
    seed: int = 0,
) -> list[FastaRecord]:
    """Simulate reads with ground truth in the id line:
    ``simulated-{i} (seqid:{}, pos:{}, trans:{})``."""
    rng = np.random.default_rng(seed)
    seqs = [normalize_reference(s, rng) for s in sequences]
    total = sum(len(s) for s in seqs)
    if total == 0:
        raise ValueError("empty reference")

    records = []
    for i in range(num_reads):
        sub, ins, dele = sub_errors, ins_errors, del_errors
        for _ in range(random_errors):
            r = int(rng.integers(0, 3))
            if r == 0:
                sub += 1
            elif r == 1:
                ins += 1
            else:
                dele += 1
        tr = Transcript.generate(rng, read_length, sub, ins, dele)
        span_len = tr.length_of_ref

        # uniform position over the concatenation, rejecting spans that
        # overrun their sequence
        while True:
            pos = int(rng.integers(0, total))
            seq_id, found = 0, False
            for seq in seqs:
                if pos + span_len <= len(seq):
                    found = True
                    break
                if pos < len(seq):
                    break
                pos -= len(seq)
                seq_id += 1
            if found:
                break

        span = seqs[seq_id][pos : pos + span_len]
        read = tr.apply(span, rng)
        records.append(
            FastaRecord(id=f"simulated-{i} (seqid:{seq_id}, pos:{pos}, trans:{tr.ops})", seq=read)
        )
    return records

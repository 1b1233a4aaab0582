"""`columba_prepare` subcommand: export text and suffix arrays for the
Columba mapper: flatten a FASTA into one $-terminated text, build the
suffix arrays of the text and of its reverse with the native SA-IS, and
write .txt/.sa/.rev.txt/.rev.sa."""

from __future__ import annotations

import numpy as np

from sahara_tpu_torch.alphabet import dna4_char_to_rank, INVALID_RANK, dna4_normalize_char
from sahara_tpu_torch.io.fasta import read_fasta
from sahara_tpu_torch.native import suffix_array

_ACGT = b"ACGT"


def _load_fasta_as_single_text(path, rng) -> bytes:
    """Flatten all records into one text; non-ACGT chars replaced with
    random ACGT; '$' appended."""
    chunks = []
    for record in read_fasta(path):
        norm = dna4_normalize_char(record.seq)
        arr = np.frombuffer(norm, dtype=np.uint8).copy()
        bad = dna4_char_to_rank(norm) == INVALID_RANK
        n_bad = int(bad.sum())
        if n_bad:
            arr[bad] = np.frombuffer(_ACGT, dtype=np.uint8)[rng.integers(0, 4, size=n_bad)]
        chunks.append(arr.tobytes())
    return b"".join(chunks) + b"$"


def _create_sa(text: bytes) -> np.ndarray:
    return suffix_array(np.frombuffer(text, dtype=np.uint8))


def _write_sa(path, sa: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write(" ".join(str(int(x)) for x in sa))


def cmd_columba_prepare(args):
    rng = np.random.default_rng(0)
    print("reading string T from fasta file...")
    text = _load_fasta_as_single_text(args.input, rng)

    print("saving text T to disk...")
    with open(args.output + ".txt", "wb") as fh:
        fh.write(text)
    print(f"-> {args.output}.txt")

    print("constructing Suffix Array for T...")
    sa = _create_sa(text)
    print("saving Suffix Array disk...")
    _write_sa(args.output + ".sa", sa)
    print(f"-> {args.output}.sa")

    print("reversing text T...")
    rev = text[::-1]
    print("saving reversed text T to disk...")
    with open(args.output + ".rev.txt", "wb") as fh:
        fh.write(rev)
    print(f"-> {args.output}.rev.txt")

    print("constructing Suffix Array for reverse T...")
    sa_rev = _create_sa(rev)
    print("saving Suffix Array (reversed T) disk...")
    _write_sa(args.output + ".rev.sa", sa_rev)
    print(f"-> {args.output}.rev.sa")


def register(subparsers):
    p = subparsers.add_parser("columba_prepare", help="takes a fasta file and prepares it for columba")
    p.add_argument("-i", "--input", required=True, help="path to a fasta file")
    p.add_argument("-o", "--output", required=True, help="base path (without extensions)")
    p.set_defaults(func=cmd_columba_prepare)

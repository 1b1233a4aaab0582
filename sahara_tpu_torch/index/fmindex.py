"""FM-index containers (host-side NumPy arrays) and the ``.idx`` container.

The container is the one ``sahara_tpu`` writes: a flat ``.npz`` with an
explicit format version, so both packages read each other's indexes.

Text layout invariant: sequences are concatenated, each padded with sentinel
zeros so every sequence starts at a multiple of the SA sampling rate.  Hence
every LF-walk from a hit ends at a sampled text position inside the same
sequence after < rate steps.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import zipfile

import numpy as np
import numpy.lib.format as npf

FORMAT_VERSION = 2  # v2 adds the optional packed text store (text4)
_READABLE_VERSIONS = (1, 2)


@dataclasses.dataclass
class FMIndex:
    """Unidirectional FM-index over a sequence collection."""

    sigma: int
    alphabet_name: str
    rate: int  # SA sampling rate
    n: int  # total (padded) text length
    occ: np.ndarray  # int32[W, 2*sigma] — see occtable.build_occ
    c_arr: np.ndarray  # int32[sigma+1] — C[c] = #symbols < c in the text
    sampled: np.ndarray  # int32[W, 2] — occ-structure over the sampled-row bitvector
    sample_seq: np.ndarray  # int32[S] — seqId per sampled row (row-rank order)
    sample_pos: np.ndarray  # int32[S] — seqPos per sampled row
    seq_lens: np.ndarray  # int64[m] — original sequence lengths
    text4: np.ndarray | None = None  # packed text (textstore.py), int32[ceil(n/8)]
    # full suffix array (absolute padded-text positions, int32[n]), kept for
    # texts up to build.FULL_SA_MAX chars: locate becomes one gather
    sa_abs: np.ndarray | None = None

    def seq_starts(self) -> np.ndarray:
        """Start offset of each sequence in the padded text layout."""
        padded = (self.seq_lens + self.rate) // self.rate * self.rate
        return np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)


@dataclasses.dataclass
class BiFMIndex(FMIndex):
    """Bidirectional FM-index: adds the reversed-text occ table (None when
    the collection is closed under reversal, ``mirrored``)."""

    occ_rev: np.ndarray | None = None
    mirrored: bool = False


def save_index(path, index: FMIndex) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "bi" if isinstance(index, BiFMIndex) else "uni",
        "sigma": index.sigma,
        "alphabet": index.alphabet_name,
        "rate": index.rate,
        "n": index.n,
        "mirrored": bool(getattr(index, "mirrored", False)),
    }
    arrays = {
        "occ": index.occ,
        "c_arr": index.c_arr,
        "sampled": index.sampled,
        "sample_seq": index.sample_seq,
        "sample_pos": index.sample_pos,
        "seq_lens": index.seq_lens,
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    if isinstance(index, BiFMIndex) and index.occ_rev is not None:
        arrays["occ_rev"] = index.occ_rev
    if index.text4 is not None:
        arrays["text4"] = index.text4
    if index.sa_abs is not None:
        arrays["sa_abs"] = index.sa_abs
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)


class FastNpz:
    """npz reader for large members.

    ``np.savez`` stores members uncompressed, so each member's bytes are
    sliced straight out of the archive with one read (or a zero-copy view of
    an in-memory source) instead of NumPy's chunked copy loop."""

    def __init__(self, source):
        self._own = not hasattr(source, "read")
        fh = open(source, "rb") if self._own else source
        self._fh = fh
        self._buf = fh.getbuffer() if isinstance(fh, io.BytesIO) else None
        self.zf = zipfile.ZipFile(fh)
        self.files = [n[:-4] for n in self.zf.namelist() if n.endswith(".npy")]

    def _member_bytes(self, name: str):
        info = self.zf.getinfo(name)
        if info.compress_type != zipfile.ZIP_STORED:
            return self.zf.read(name)
        # local file header: 30 fixed bytes, then name + extra (lengths in
        # the local header can differ from the central directory's)
        if self._buf is not None:
            h = self._buf[info.header_offset : info.header_offset + 30]
            nlen, elen = struct.unpack("<HH", bytes(h[26:30]))
            off = info.header_offset + 30 + nlen + elen
            return self._buf[off : off + info.file_size]
        self._fh.seek(info.header_offset + 26)
        nlen, elen = struct.unpack("<HH", self._fh.read(4))
        self._fh.seek(info.header_offset + 30 + nlen + elen)
        return self._fh.read(info.file_size)

    def __getitem__(self, key: str) -> np.ndarray:
        """Read-only view of one member (index arrays are never mutated)."""
        raw = self._member_bytes(key + ".npy")
        head = io.BytesIO(bytes(raw[:4096]))
        version = npf.read_magic(head)
        if version == (1, 0):
            shape, fortran, dtype = npf.read_array_header_1_0(head)
        elif version == (2, 0):
            shape, fortran, dtype = npf.read_array_header_2_0(head)
        else:
            return np.load(io.BytesIO(bytes(raw)), allow_pickle=False)
        off = head.tell()
        if dtype.hasobject or off >= 4096:
            return np.load(io.BytesIO(bytes(raw)), allow_pickle=False)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
        if fortran:
            return arr.reshape(shape[::-1]).T
        return arr.reshape(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.zf.close()
        if self._own:
            self._fh.close()


def from_arrays(arrays, meta: dict) -> FMIndex:
    """Host index from its named arrays (the ``.idx`` member names) and its
    metadata (``kind``, ``sigma``, ``alphabet``, ``rate``, ``n``,
    ``mirrored``) — e.g. the arrays of a ``sahara_tpu`` host index."""
    common = dict(
        sigma=int(meta["sigma"]),
        alphabet_name=meta["alphabet"],
        rate=int(meta["rate"]),
        n=int(meta["n"]),
        occ=arrays["occ"],
        c_arr=arrays["c_arr"],
        sampled=arrays["sampled"],
        sample_seq=arrays["sample_seq"],
        sample_pos=arrays["sample_pos"],
        seq_lens=arrays["seq_lens"],
        text4=arrays["text4"] if "text4" in arrays else None,
        sa_abs=arrays["sa_abs"] if "sa_abs" in arrays else None,
    )
    if meta["kind"] == "bi":
        return BiFMIndex(
            **common,
            occ_rev=arrays["occ_rev"] if "occ_rev" in arrays else None,
            mirrored=bool(meta.get("mirrored", False)),
        )
    return FMIndex(**common)


def read_meta(path) -> dict:
    """The JSON metadata member of an index file, read alone."""
    with FastNpz(path) as data:
        return json.loads(bytes(data["meta"]).decode())


def peek_sigma(path) -> int:
    """The alphabet size of an index file, without loading its arrays."""
    return int(read_meta(path)["sigma"])


def load_index(path) -> FMIndex:
    with FastNpz(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["format_version"] not in _READABLE_VERSIONS:
            raise ValueError(f"unknown file format version for index: {meta['format_version']}")
        return from_arrays({name: data[name] for name in data.files if name != "meta"}, meta)

"""AdaptiveKmerIndex: an FM-index over a dense kmer alphabet.

The counterpart of ``sahara_tpu/adaptive_kmer_index.py`` (the reference's
``AdaptiveKmerIndex``): the alphabet is the dense id space of a kmer sketch,
its size bucketed to {3, 4, 5, 6, 16, 32, 64, 128}; search is exact search
plus locate on one device (K6 and K7 on the card); the ``.kmer.idx``
container (format version 1) is the one ``sahara_tpu`` writes: an npz of
``kmer_meta`` (JSON), ``inner_index`` (the ``.idx`` bytes), ``uniq_keys``
(uint64 sketch values) and ``uniq_vals`` (int64 dense ids), so each package
loads the other's files.
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

from sahara_tpu_torch.engine.device import DeviceIndex, pad_queries, resolve_device
from sahara_tpu_torch.engine.exact import exact_search
from sahara_tpu_torch.engine.locate import locate
from sahara_tpu_torch.index.build import build_fmindex
from sahara_tpu_torch.index.fmindex import FastNpz, FMIndex, load_index, save_index
from sahara_tpu_torch.utils.errors import SaharaError

FILE_FORMAT_VERSION = 0x01
_SIGMA_BUCKETS = (3, 4, 5, 6, 16, 32, 64, 128)


def _bucket_sigma(largest_value: int) -> int:
    for b in _SIGMA_BUCKETS:
        if largest_value < b:
            return b
    raise SaharaError(f"text with values above 128 is not allowed (requested largest value: {largest_value})")


@dataclasses.dataclass
class KmerConfig:
    mode: str  # 'winnowing' | 'mod'
    kmer_len: int
    window: int  # winnowing only
    mod_exp: int  # mod only
    largest_value: int


class AdaptiveKmerIndex:
    def __init__(self, config: KmerConfig, kmer_seqs: list[np.ndarray] | None = None,
                 host_index: FMIndex | None = None):
        self.config = config
        self.sigma = _bucket_sigma(config.largest_value)
        if host_index is None:
            if kmer_seqs is None:
                raise ValueError("need kmer sequences or a prebuilt index")
            host_index = build_fmindex([np.asarray(s, dtype=np.uint8) for s in kmer_seqs], self.sigma,
                                       f"kmer{self.sigma}", rate=16)
        self.host_index = host_index
        self._device: dict[torch.device, DeviceIndex] = {}

    def device_index(self, device="cuda") -> DeviceIndex:
        """The index uploaded to ``device`` (once per device)."""
        dev = resolve_device(device)
        if dev not in self._device:
            self._device[dev] = DeviceIndex.from_host(self.host_index, device=dev)
        return self._device[dev]

    def search_rows(self, queries: list[np.ndarray], device="cuda") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact search + locate of kmer-id queries: (query, refId, refPos)
        int64 arrays, queries in order and each query's hits in locate
        order."""
        if not queries:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        q, lens = pad_queries(queries)
        dev = self.device_index(device)
        lb, ln = exact_search(dev, q, lens)
        src, seq_id, pos = locate(dev, lb, ln)
        return tuple(t.cpu().numpy().astype(np.int64) for t in (src, seq_id, pos))

    def search(self, queries: list[np.ndarray], device="cuda") -> list[list[tuple[int, int]]]:
        """[(refId, refPos), ...] per query, in locate order."""
        out: list[list[tuple[int, int]]] = [[] for _ in queries]
        for s, sid, p in zip(*(a.tolist() for a in self.search_rows(queries, device))):
            out[s].append((sid, p))
        return out

    def save(self, path: str, uniq: dict[int, int]) -> None:
        """The versioned container: config, index and the dense kmer map."""
        meta = dataclasses.asdict(self.config)
        meta["file_format_version"] = FILE_FORMAT_VERSION
        buf = io.BytesIO()
        save_index(buf, self.host_index)
        with open(path, "wb") as fh:
            np.savez(
                fh,
                kmer_meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                inner_index=np.frombuffer(buf.getvalue(), dtype=np.uint8),
                uniq_keys=np.fromiter(uniq.keys(), dtype=np.uint64, count=len(uniq)),
                uniq_vals=np.fromiter(uniq.values(), dtype=np.int64, count=len(uniq)),
            )

    @staticmethod
    def load(path: str) -> tuple["AdaptiveKmerIndex", dict[int, int]]:
        with FastNpz(path) as data:
            meta = json.loads(bytes(data["kmer_meta"]).decode())
            version = meta.pop("file_format_version")
            if version != FILE_FORMAT_VERSION:
                raise ValueError(f"unknown file format version for index: {version}")
            inner = load_index(io.BytesIO(bytes(data["inner_index"])))
            uniq = dict(zip(data["uniq_keys"].tolist(), data["uniq_vals"].tolist()))
        return AdaptiveKmerIndex(KmerConfig(**meta), host_index=inner), uniq

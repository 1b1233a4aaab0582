"""Tape compiler: expanded search schemes -> flat instruction arrays.

A copy of ``sahara_tpu/engine/tape.py`` (host only).  Where
``fmc::search_ng24::search`` does a recursive per-query DFS over the scheme's
error tree (call site search.cpp:227-231), we compile each expanded search
into a static *tape* indexed by d = number of query characters consumed:

    side[d]  : 0 = extend left (forward occ table), 1 = extend right
               (reversed-text occ table)
    qpos[d]  : which query position the d-th consumed character is
    lo[d]    : minimum cumulative errors after consuming d+1 characters
    hi[d]    : maximum cumulative errors after consuming d+1 characters

All searches of a scheme share the tape shape [ns, m], so every
(query, search) lane of a chunk steps through one shared state queue
(``engine/workq.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sahara_tpu_torch.schemes.types import Scheme, Search


@dataclasses.dataclass(frozen=True)
class SchemeTape:
    """Host-side tape arrays for one expanded scheme (all int32[ns, m])."""

    side: np.ndarray
    qpos: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    @property
    def num_searches(self) -> int:
        return self.side.shape[0]

    @property
    def length(self) -> int:
        return self.side.shape[1]

    @property
    def max_errors(self) -> int:
        return int(self.hi.max()) if self.hi.size else 0


def _search_sides(s: Search) -> list[int]:
    """Per-consumed-character extension direction for an *expanded* search.

    An expanded search's pi lists query positions in consumption order; a
    position smaller than everything consumed so far is a left extension,
    larger is a right extension (connectivity guarantees one of the two)."""
    sides = [0]  # first char: extend left by convention (backward search)
    lo = hi = s.pi[0]
    for p in s.pi[1:]:
        if p == hi + 1:
            sides.append(1)
            hi = p
        elif p == lo - 1:
            sides.append(0)
            lo = p
        else:
            raise ValueError(f"expanded search is not connectivity-preserving: {s.pi}")
    return sides


def compile_tape(expanded: Scheme) -> SchemeTape:
    """Compile an expanded scheme (per-position searches of equal length)
    into stacked tape arrays."""
    if not expanded:
        raise ValueError("empty scheme")
    m = len(expanded[0].pi)
    ns = len(expanded)
    side = np.zeros((ns, m), dtype=np.int32)
    qpos = np.zeros((ns, m), dtype=np.int32)
    lo = np.zeros((ns, m), dtype=np.int32)
    hi = np.zeros((ns, m), dtype=np.int32)
    for i, s in enumerate(expanded):
        if len(s.pi) != m:
            raise ValueError("all searches in a scheme must have equal expanded length")
        side[i] = _search_sides(s)
        qpos[i] = s.pi
        lo[i] = s.l
        hi[i] = s.u
    return SchemeTape(side=side, qpos=qpos, lo=lo, hi=hi)

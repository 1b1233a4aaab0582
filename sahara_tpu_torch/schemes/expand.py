"""Scheme expansion: abstract per-part schemes -> per-position schemes.

Equivalent of ``fmc::search_scheme::expand`` / ``expandCount`` /
``limitToHamming`` (reference call sites search.cpp:191,201,226,
search_scheme.cpp:91,113).  An expanded Search has one entry per query
position: ``pi`` = the query positions in the order they are consumed,
``u[d]`` = the maximum cumulative errors allowed after consuming d+1
characters (the current part's bound), ``l[d]`` = the minimum cumulative
errors required (the bound of the last *completed* part — lower bounds only
jump at part-completion positions, since an error inside a part may sit at
its final character).
"""

from __future__ import annotations

from sahara_tpu_torch.schemes.types import Scheme, Search


def expand_count(parts: int, length: int) -> list[int]:
    """Distribute ``length`` positions over ``parts`` parts as evenly as
    possible (earlier parts take the remainder)."""
    if parts <= 0:
        return []
    base, rem = divmod(length, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def part_directions(pi: tuple[int, ...]) -> list[int]:
    """Direction each part is consumed in: 0 = extend left (the part lies to
    the left of the matched span; its positions are consumed right-to-left),
    1 = extend right.  The first part is consumed right-to-left (backward
    search) by convention."""
    dirs = [0]
    hi = lo = pi[0]
    for x in pi[1:]:
        if x == hi + 1:
            dirs.append(1)
            hi = x
        else:
            dirs.append(0)
            lo = x
    return dirs


def expand_search(s: Search, counts: list[int]) -> Search:
    """Expand one search to per-position form given part lengths."""
    starts = [0]
    for c in counts[:-1]:
        starts.append(starts[-1] + c)
    dirs = part_directions(s.pi)

    pi_expanded: list[int] = []
    l_expanded: list[int] = []
    u_expanded: list[int] = []
    prev_l = 0
    for j, part in enumerate(s.pi):
        lo = starts[part]
        n = counts[part]
        positions = list(range(lo, lo + n))
        if dirs[j] == 0:
            positions.reverse()
        for t, pos in enumerate(positions):
            pi_expanded.append(pos)
            u_expanded.append(s.u[j])
            l_expanded.append(s.l[j] if t == n - 1 else prev_l)
        prev_l = s.l[j]
    return Search(pi=tuple(pi_expanded), l=tuple(l_expanded), u=tuple(u_expanded))


def expand(ss: Scheme, length_or_counts: int | list[int]) -> Scheme:
    """Expand a scheme to a query length (uniform part sizes) or explicit
    per-part counts (search.cpp:191 uses the uniform path)."""
    if not ss:
        return []
    parts = ss[0].parts
    counts = (
        expand_count(parts, length_or_counts)
        if isinstance(length_or_counts, int)
        else list(length_or_counts)
    )
    if len(counts) != parts:
        raise ValueError(f"expected {parts} part counts, got {len(counts)}")
    if any(c <= 0 for c in counts):
        raise ValueError(f"parts must be non-empty (query too short for {parts} parts)")
    return [expand_search(s, counts) for s in ss]


def limit_to_hamming(ss: Scheme) -> Scheme:
    """Tighten an expanded scheme for Hamming semantics: under Hamming each
    remaining character contributes at most one error, so a state at depth d
    with fewer than ``l_final - (m-1-d)`` errors can never satisfy the final
    lower bound — ramp the lower bounds up accordingly.  [inferred semantics
    of ``fmc::search_scheme::limitToHamming``, call site search.cpp:226]"""
    out = []
    for s in ss:
        m = len(s.pi)
        l = list(s.l)
        lf = l[-1]
        for d in range(m):
            l[d] = max(l[d], lf - (m - 1 - d))
        # keep monotone + within u
        for d in range(1, m):
            l[d] = max(l[d], l[d - 1])
        out.append(Search(pi=s.pi, l=tuple(l), u=s.u))
    return out

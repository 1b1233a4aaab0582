"""Search-scheme cost models + dynamic partition optimization.

Equivalents of ``fmc::search_scheme::nodeCount`` / ``weightedNodeCount`` /
``optimizeByWNC[TopDown]`` / ``expandByWNC[TopDown]`` (reference call sites
search.cpp:193-208, search_scheme.cpp:136-143,221-226).

The node count of an expanded search is the number of nodes of its error
tree: paths through (depth, errors) states respecting the per-position
bounds.  The weighted node count discounts each node at text depth D by the
probability a random text of length N contains the corresponding string:
min(1, N / sigma_real**D) — the expected number of *visited* (non-empty
interval) nodes, which predicts actual search work.
"""

from __future__ import annotations

from sahara_tpu_torch.schemes.expand import expand
from sahara_tpu_torch.schemes.types import Scheme, Search


def _search_node_count(s: Search, sigma: int, n_text: float | None, edit: bool) -> float:
    """DP over (chars consumed d, errors e) -> number of paths; nodes are
    cursor extensions (insertions consume a query char without extending the
    cursor; deletions extend without consuming)."""
    m = len(s.pi)
    k = max(s.u) if s.u else 0
    sig = max(sigma - 1, 1)  # branching over real symbols

    total = 0.0
    # paths[e] = number of paths with e errors after consuming d chars
    paths = [0.0] * (k + 2)
    paths[0] = 1.0
    for d in range(m):
        lo, hi = s.l[d], s.u[d]
        new = [0.0] * (k + 2)
        for e in range(hi + 1):
            ways = paths[e]  # match
            if e > 0:
                ways += paths[e - 1] * (sig - 1)  # substitution
                if edit:
                    ways += paths[e - 1]  # insertion (no cursor extension)
            new[e] = ways
        if edit:
            # deletions: extend cursor without consuming a char; bounded by e
            for e in range(1, hi + 1):
                new[e] += new[e - 1] * sig
        for e in range(hi + 1):
            if e < lo:
                new[e] = 0.0
        paths = new
        if n_text is None:
            weight = 1.0
        else:
            # random-text survival probability at text depth ~ d+1
            weight = min(1.0, n_text / (float(max(sigma - 1, 2)) ** (d + 1)))
        total += sum(paths) * weight
    return total


def node_count(ss: Scheme, sigma: int, edit: bool = False) -> float:
    """Total number of error-tree nodes over all searches of an expanded
    scheme (``nodeCount<Edit>``, search.cpp:197,207)."""
    return sum(_search_node_count(s, sigma, None, edit) for s in ss)


def weighted_node_count(ss: Scheme, sigma: int, n_text: int, edit: bool = False) -> float:
    """Expected number of visited nodes on a random text of length
    ``n_text`` (``weightedNodeCount<Edit>``, search.cpp:198,208)."""
    return sum(_search_node_count(s, sigma, float(n_text), edit) for s in ss)


def _uniform_counts(parts: int, length: int) -> list[int]:
    base, rem = divmod(length, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def optimize_by_wnc(
    ss: Scheme, length: int, sigma: int, n_text: int, edit: bool = True
) -> list[int]:
    """Bottom-up partition optimization (``optimizeByWNC`` analogue,
    search_scheme.cpp:221-226): first-improvement hill climb from the
    uniform partition, moving one character between parts at a time (the
    exact reference optimizer is internal to fmindex-collection — this
    reimplementation matches its contract: a partition of ``length`` whose
    expanded scheme minimizes WNC)."""
    if not ss:
        return []
    parts = ss[0].parts
    counts = _uniform_counts(parts, length)
    if parts == 1 or counts[-1] == 0:
        return counts

    def cost(c: list[int]) -> float:
        return weighted_node_count(expand(ss, c), sigma, n_text, edit)

    best = cost(counts)
    improved = True
    while improved:
        improved = False
        for i in range(parts):
            for j in range(parts):
                if i == j or counts[i] <= 1:
                    continue
                counts[i] -= 1
                counts[j] += 1
                c = cost(counts)
                if c < best - 1e-9:
                    best = c
                    improved = True
                else:
                    counts[i] += 1
                    counts[j] -= 1
    return counts


def optimize_by_wnc_topdown(
    ss: Scheme, length: int, sigma: int, n_text: int, edit: bool = True
) -> list[int]:
    """Top-down partition optimization (``optimizeByWNCTopDown`` analogue,
    search.cpp:193-195): steepest-descent with progressively smaller move
    granularity — starting from the uniform partition, repeatedly apply
    the single best transfer of ``step`` characters between any two parts,
    halving ``step`` (length/4, length/8, ..., 1) as moves stop helping.
    Reaches strongly uneven partitions the one-character bottom-up climb
    cannot cross over to."""
    if not ss:
        return []
    parts = ss[0].parts
    counts = _uniform_counts(parts, length)
    if parts == 1 or counts[-1] == 0:
        return counts

    def cost(c: list[int]) -> float:
        return weighted_node_count(expand(ss, c), sigma, n_text, edit)

    best = cost(counts)
    step = max(length // 4, 1)
    while step >= 1:
        moved = False
        while True:
            cand_best, cand = None, None
            for i in range(parts):
                if counts[i] <= step:
                    continue
                for j in range(parts):
                    if i == j:
                        continue
                    counts[i] -= step
                    counts[j] += step
                    c = cost(counts)
                    counts[i] += step
                    counts[j] -= step
                    if c < best - 1e-9 and (cand_best is None or c < cand_best):
                        cand_best, cand = c, (i, j)
            if cand is None:
                break
            i, j = cand
            counts[i] -= step
            counts[j] += step
            best = cand_best
            moved = True
        step = step // 2 if step > 1 else 0
        if not moved and step == 0:
            break
    return counts


def expand_by_wnc(ss: Scheme, length: int, sigma: int, n_text: int, edit: bool = True) -> Scheme:
    """Expand with the bottom-up WNC-optimized partition (``expandByWNC``
    analogue, search_scheme.cpp:221-226)."""
    return expand(ss, optimize_by_wnc(ss, length, sigma, n_text, edit))


def expand_by_wnc_topdown(ss: Scheme, length: int, sigma: int, n_text: int, edit: bool = True) -> Scheme:
    """Expand with the top-down WNC-optimized partition
    (``expandByWNCTopDown`` analogue, search.cpp:195,205)."""
    return expand(ss, optimize_by_wnc_topdown(ss, length, sigma, n_text, edit))

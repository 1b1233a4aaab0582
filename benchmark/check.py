"""The comparison that decides ``correct``: the rows of every batch the
run searched against the plain reference's rows for the same reads.

Each number compared is an exact count with the limit 0.  A row is keyed
by (query, seq, pos); ``errors`` is compared on the keys both sides hold.
A row the program gives twice counts as extra.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"missing_rows": 0, "extra_rows": 0, "wrong_errors": 0, "unanswered_batches": 0}


def _keys(q: np.ndarray, s: np.ndarray, p: np.ndarray) -> np.ndarray:
    """One int64 a (query, seq, pos): 24 bits of query, 8 of seq, 32 of pos."""
    if len(q) and (q.max() >= 1 << 24 or s.max() >= 1 << 8 or p.max() >= 1 << 32 or min(q.min(), s.min(), p.min()) < 0):
        raise ValueError("row outside the key's range")
    return (q.astype(np.int64) << 40) | (s.astype(np.int64) << 32) | p.astype(np.int64)


def compare(want: dict[str, np.ndarray], got: dict[str, np.ndarray]) -> dict[str, int]:
    """Counts of ``missing_rows``, ``extra_rows`` and ``wrong_errors`` of
    ``got`` against ``want`` (arrays ``query``, ``seq``, ``pos``,
    ``errors``)."""
    wk = _keys(want["query"], want["seq"], want["pos"])
    gk = _keys(got["query"], got["seq"], got["pos"])
    w_order, g_order = np.argsort(wk, kind="stable"), np.argsort(gk, kind="stable")
    wk, we = wk[w_order], np.asarray(want["errors"])[w_order]
    gk, ge = gk[g_order], np.asarray(got["errors"])[g_order]
    g_first = np.r_[True, gk[1:] != gk[:-1]] if len(gk) else np.zeros(0, dtype=bool)
    dupes = int((~g_first).sum())
    gk, ge = gk[g_first], ge[g_first]
    common, wi, gi = np.intersect1d(wk, gk, assume_unique=True, return_indices=True)
    return dict(
        missing_rows=len(wk) - len(common),
        extra_rows=len(gk) - len(common) + dupes,
        wrong_errors=int((we[wi] != ge[gi]).sum()),
    )


def same(a: dict[str, np.ndarray], b: dict[str, np.ndarray]) -> bool:
    """Two answers equal row for row."""
    return all(np.array_equal(a[f], b[f]) for f in ("query", "seq", "pos", "errors"))


def judge(want: list[dict], answers: list[tuple[int, dict | None]]) -> dict[str, int]:
    """The numbers compared over every answer: ``answers`` holds (pool
    batch, rows or None where the batch raised); ``want[b]`` is the
    reference's rows of pool batch b.  Answers equal to one already
    compared are counted from that one's numbers."""
    totals = dict.fromkeys(LIMITS, 0)
    seen: dict[int, list[tuple[dict, dict]]] = {}
    for b, rows in answers:
        if rows is None:
            totals["unanswered_batches"] += 1
            continue
        known = next((n for r, n in seen.get(b, []) if same(r, rows)), None)
        if known is None:
            known = compare(want[b], rows)
            seen.setdefault(b, []).append((rows, known))
        for name, v in known.items():
            totals[name] += v
    return totals


def verdict(numbers: dict[str, int]) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def lines(numbers: dict[str, int]) -> list[str]:
    return [f"check {name}: {numbers[name]} (limit {limit})" for name, limit in LIMITS.items()]


def as_json(numbers: dict[str, int]) -> dict:
    return {name: {"value": numbers[name], "limit": limit} for name, limit in LIMITS.items()}

"""``sahara_tpu_torch``'s ``_merge_results`` against a four-key lexsort and
against ``sahara_tpu``'s ``_merge_results``, row for row and dtype for
dtype, on the packed-key path and on the lexsort fallback, with the
tracer's counters ``driver.merge_rows`` and ``driver.merge_lexsort``."""

import numpy as np
import pytest

from sahara_tpu.engine.driver import SearchResult as JaxSearchResult
from sahara_tpu.engine.driver import _merge_results as jax_merge_results
from sahara_tpu_torch import trace
from sahara_tpu_torch.engine.driver import KEY_BITS, SearchResult, _merge_results

from tests import torch_support  # noqa: F401  (PyTorch on one thread)

FIELDS = ("query_id", "seq_id", "pos", "errors")


def _lexsort_formula(parts):
    """The merge as a four-key lexsort: concatenate, sort by (q, s, p, e),
    keep the first row of each (q, s, p) run."""
    q, s, p, e = (np.concatenate([part[i] for part in parts]) for i in range(4))
    if len(q) == 0:
        return q, s, p, e
    order = np.lexsort((e, p, s, q))
    q, s, p, e = q[order], s[order], p[order], e[order]
    keep = np.r_[True, (q[1:] != q[:-1]) | (s[1:] != s[:-1]) | (p[1:] != p[:-1])]
    return q[keep], s[keep], p[keep], e[keep]


def _rows(rng, n, *, q=(0, 500), s=(0, 3), p=(0, 10_000), e=(0, 2), dup=0.4):
    """``n`` rows with fields drawn from the inclusive ranges given (each
    range's ends planted, so the widths are exact where ``n`` > 1); a
    share ``dup`` of rows repeats the (q, s, p) of an earlier row at a
    random error."""
    ranges = (q, s, p, e)
    cols = [rng.integers(lo, hi, n, endpoint=True, dtype=np.int64) for lo, hi in ranges]
    src = rng.integers(0, n, n)
    again = rng.random(n) < dup
    for c in cols[:3]:
        c[again] = c[src[again]]
    if n > 1:
        for c, ends in zip(cols, ranges):
            c[rng.choice(n, 2, replace=False)] = ends
    return cols


def _split(rng, cols, n_parts):
    """``cols`` cut into ``n_parts`` parts at random points, shuffled."""
    n = len(cols[0])
    order = rng.permutation(n)
    cuts = np.sort(rng.integers(0, n + 1, n_parts - 1))
    return [[c[order][a:b] for c in cols] for a, b in zip(np.r_[0, cuts], np.r_[cuts, n])]


def _case(name, rng):
    """(parts, packed): each part the four columns of a ``SearchResult``;
    ``packed`` whether the widths fit ``KEY_BITS``."""
    if name == "random_dups":
        return _split(rng, _rows(rng, 4_000), 7), True
    if name == "empty_and_single_parts":
        cols = _rows(rng, 600)
        one = [c[:1] for c in _rows(rng, 1)]
        none = [np.zeros(0, dtype=np.int64)] * 4
        return [none] + _split(rng, cols, 3) + [none, one, none], True
    if name == "all_parts_empty":
        return [[np.zeros(0, dtype=np.int64)] * 4 for _ in range(3)], True
    if name == "no_parts":
        return [], True
    if name == "single_row":
        return [_rows(rng, 1, q=(7, 7), s=(2, 2), p=(99, 99), e=(1, 1))], True
    if name == "one_seq_record":
        return _split(rng, _rows(rng, 3_000, q=(0, 865_919), s=(0, 0), p=(0, 40_000_000)), 5), True
    if name == "negative_and_offset":
        return _split(rng, _rows(rng, 2_000, q=(-300, 200), s=(-5, 4), p=(10**12 - 5_000, 10**12), e=(-1, 3)), 4), True
    if name == "widths_63":
        # 30 + 5 + 26 + 2 bits
        return _split(rng, _rows(rng, 3_000, q=(-(2**29), 2**29 - 1), s=(0, 31), p=(0, 2**26 - 1), e=(0, 3)), 4), True
    if name == "widths_64":
        # 31 + 5 + 26 + 2 bits
        return _split(rng, _rows(rng, 3_000, q=(0, 2**31 - 1), s=(0, 31), p=(0, 2**26 - 1), e=(0, 3)), 4), False
    if name == "widths_81":
        # a sharded index's worst case: 2^30 query ids, 2^20 records, 2^28 positions, 3 bits of errors
        return _split(rng, _rows(rng, 3_000, q=(0, 2**30 - 1), s=(0, 2**20 - 1), p=(0, 2**28 - 1), e=(0, 7)), 4), False
    if name == "full_int64_range":
        return _split(rng, _rows(rng, 1_000, p=(-(2**63), 2**63 - 1)), 3), False
    raise ValueError(name)


CASES = ["random_dups", "empty_and_single_parts", "all_parts_empty", "no_parts", "single_row", "one_seq_record",
         "negative_and_offset", "widths_63", "widths_64", "widths_81", "full_int64_range"]
KEY_WIDTHS = {"widths_63": 63, "widths_64": 64, "widths_81": 81}  # the bits the cases' rows need


@pytest.mark.parametrize("name", CASES)
def test_merge_matches_lexsort_and_jax(name):
    rng = np.random.default_rng(1600 + CASES.index(name))
    parts, packed = _case(name, rng)
    before = [[c.copy() for c in part] for part in parts]
    timer = trace.StageTimer("cpu")
    with trace.tracing(timer):
        got = _merge_results([SearchResult(*part) for part in parts])
    got = [getattr(got, f) for f in FIELDS]
    want = _lexsort_formula(parts) if parts else [np.zeros(0, dtype=np.int64)] * 4
    jax = jax_merge_results([JaxSearchResult(*part) for part in parts])
    for ref in (want, [getattr(jax, f) for f in FIELDS]):
        for g, w in zip(got, ref):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for part, old in zip(parts, before):
        for c, o in zip(part, old):
            np.testing.assert_array_equal(c, o)
    n_rows = sum(len(part[0]) for part in parts)
    counters = timer.report()["counters"]
    assert counters["driver.merge_rows"] == n_rows
    assert counters.get("driver.merge_lexsort", 0) == (0 if packed or n_rows == 0 else 1)
    assert timer.report()["spans"]["driver.merge"]["count"] == 1
    if name in KEY_WIDTHS:
        cols = [np.concatenate([part[i] for part in parts]) for i in range(4)]
        bits = sum((int(c.max()) - int(c.min())).bit_length() for c in cols)
        assert bits == KEY_WIDTHS[name] and (bits <= KEY_BITS) == packed

"""The plain reference against brute force on a tiny text, and against
the program's own search on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import genome, reads, reference

INF = reference.INF


def brute_errors(query, flat, p: int, k: int) -> int:
    """The least edits of ``query`` against any span that starts at ``p``,
    by the full dynamic programme over the longest span (a shorter span's
    cells are a prefix of it): the span's first char may not be deleted,
    and a 0 char can be neither matched, substituted nor deleted."""
    m = len(query)
    span = []
    for j in range(m + k):
        c = int(flat[p + j]) if 0 <= p + j < len(flat) else 0
        if c == 0:
            break
        span.append(c)
    d = [[INF] * (len(span) + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        d[i][0] = i
    for i in range(m + 1):
        for j in range(1, len(span) + 1):
            v = INF
            if i >= 1:
                v = min(d[i - 1][j - 1] + (int(query[i - 1]) != span[j - 1]), d[i - 1][j] + 1)
            if j >= 2:
                v = min(v, d[i][j - 1] + 1)
            d[i][j] = v
    return min(d[m][1:], default=INF)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(21)
    records = [rng.integers(1, 5, 170).astype(np.uint8), rng.integers(1, 5, 140).astype(np.uint8)]
    records[1][20:80] = records[0][60:120]  # a repeat across the records
    m, k = 24, 2
    queries = []
    for r in range(14):
        rec = records[r % 2]
        at = int(rng.integers(0, len(rec) - m - 2))
        ops = reads.simulate(rec[at : at + m + 2], 1, m, int(rng.integers(0, 3)), rng)[0][0]
        queries.append(ops)
    queries.append(rng.integers(1, 5, m).astype(np.uint8))
    queries.append(records[0][-m:].copy())  # runs up to the separator
    return records, np.stack(queries), k


def test_score_is_the_full_programme(small):
    records, queries, k = small
    text = reference.Text(records, 8, "cpu")
    flat = text.chars.numpy()
    qi = torch.arange(len(queries)).repeat_interleave(text.n + 2 * k)
    start = torch.arange(-k, text.n + k).repeat(len(queries))
    got = reference.score(text, torch.from_numpy(queries), qi, start, k).numpy()
    for lane in range(len(got)):
        want = brute_errors(queries[qi[lane]], flat, int(start[lane]), k)
        assert got[lane] == want if want <= k else got[lane] > k, lane


def test_hits_are_every_start_within_k(small):
    records, queries, k = small
    text = reference.Text(records, reference.g_for(queries.shape[1], k), "cpu")
    flat = text.chars.numpy()
    rows = reference.hits(text, queries, k)
    want = []
    for q in range(len(queries)):
        for p in range(text.n):
            e = brute_errors(queries[q], flat, p, k)
            if e <= k:
                seq = int(np.searchsorted(text.starts, p, side="right") - 1)
                want.append((q, seq, p - int(text.starts[seq]), e))
    got = list(zip(*(rows[f].tolist() for f in ("query", "seq", "pos", "errors"))))
    assert got == sorted(want)
    assert len(want) > 20 and any(s == 1 for _, s, _, _ in want)


@pytest.mark.parametrize("search", [
    dict(engine="auto", generator_name="h2-k2"),
    dict(engine="approx", generator_name="optimum", s_cap=64, h_cap=32),
])
def test_matches_the_program_on_the_cpu(search):
    from sahara_tpu_torch.engine.device import DeviceIndex
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.index.build import build_bifmindex

    text = genome.make_reference(np.random.default_rng(1234), 30_000)
    mix = dict(read_length=100, errors=2, mapped_fraction=1.0, batch_reads=40, pool_batches=1)
    batch = reads.make_pool(text, mix, 99)[0]
    host = build_bifmindex([text], 6, "d_dna5", rate=16)
    index = DeviceIndex.from_host(host, device="cpu")
    res = search_queries(index, batch, k=2, edit=True, mode="all", chunk=64, device="cpu", **search)
    want = reference.hits(reference.Text([text], 31, "cpu"), batch, 2)
    np.testing.assert_array_equal(res.query_id, want["query"])
    np.testing.assert_array_equal(res.seq_id, want["seq"])
    np.testing.assert_array_equal(res.pos, want["pos"])
    np.testing.assert_array_equal(res.errors, want["errors"])
    assert len(want["query"]) >= 40

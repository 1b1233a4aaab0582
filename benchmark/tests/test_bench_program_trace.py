"""The readers of the program's own spans and counters, on hand-made
reports, with their None cases; ``program_trace.report`` against the
program's tracer; and which cells read which of these metrics."""

import sys

import pytest

from benchmark import harness, program_trace

NEW = ("driver.merge_ms", "driver.sync_wait_ms", "driver.syncs", "sv.bad_mask_ms", "approx.ladder_ms",
       "approx.launch_us", "approx.retry_share")
SV, OSS = "chr21-100bp-k2-sv.mapped", ("chr21-100bp-k2-oss.mapped", "chr21-100bp-k2-oss.hostdep")


def span(count, total_ms, self_ms):
    return dict(count=count, total_ms=total_ms, self_ms=self_ms)


def report(**over):
    rep = dict(
        calls=10,
        spans={"search": span(10, 5000.0, 900.0), "driver.merge": span(10, 410.0, 400.0),
               "sync": span(2140, 300.0, 300.0), "sv.bad_mask": span(10, 150.0, 150.0),
               "approx.ladder": span(10, 3000.0, 120.0), "approx.search": span(560, 800.0, 750.0)},
        sites={"sv.counts": dict(count=530, total_ms=100.0)},
        counters={"approx.queries_searched": 200_000, "approx.queries_retried": 5_000},
        last_call=None, stages_ms={})
    rep.update(over)
    return rep


def record(**kw):
    rec = dict(reads_done=500_000, launches={"frontier_step": 60_000})
    rec.update(kw)
    return rec


def test_readers_on_a_report(read):
    rep, rec = report(), record()
    assert read("driver.merge_ms", rec, rep) == pytest.approx(400.0 / 500)
    assert read("driver.sync_wait_ms", rec, rep) == pytest.approx(300.0 / 500)
    assert read("driver.syncs", rec, rep) == pytest.approx(2140 / 500)
    assert read("sv.bad_mask_ms", rec, rep) == pytest.approx(150.0 / 500)
    assert read("approx.ladder_ms", rec, rep) == pytest.approx(120.0 / 500)
    assert read("approx.launch_us", rec, rep) == pytest.approx(750.0 * 1e3 / 60_000)
    assert read("approx.retry_share", rec, rep) == pytest.approx(2.5)
    assert read("approx.retry_share", rec, report(counters={"approx.queries_searched": 10})) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_where_nothing_fired(read, name):
    """No report (the program has no tracer, or no search had one), a span
    or counter that never fired, no reads, no K8 launch: None."""
    assert read(name, record(), None) is None
    assert read(name, record(), report(spans={}, counters={})) is None
    never = report(spans={k: span(0, 0.0, 0.0) for k in report()["spans"]},
                   counters={"approx.queries_searched": 0, "approx.queries_retried": 0})
    assert read(name, record(), never) is None
    if name != "approx.retry_share":
        assert read(name, record(reads_done=0, launches={}), report()) is None


def test_the_report_is_the_last_tracer_given_to_a_search(monkeypatch):
    from sahara_tpu_torch import trace

    monkeypatch.setattr(trace, "_last", None)
    assert program_trace.report() is None
    timer = trace.StageTimer("cpu")
    with trace.tracing(timer), trace.span("search"):
        trace.count("approx.queries_searched", 3)
    assert program_trace.report() == timer.report() and program_trace.report()["calls"] == 1
    # a program from before its tracer
    monkeypatch.delattr(sys.modules["sahara_tpu_torch"], "trace")
    monkeypatch.setitem(sys.modules, "sahara_tpu_torch.trace", None)
    assert program_trace.report() is None


def test_each_cell_reads_the_new_metrics_the_table_lists(bench):
    names = lambda cell: {m["name"] for m in harness.metrics_of(bench, cell, True)} & set(NEW)  # noqa: E731
    driver = {"driver.merge_ms", "driver.sync_wait_ms", "driver.syncs"}
    assert names(SV) == driver | {"sv.bad_mask_ms"}
    for cell in OSS:
        assert names(cell) == driver | {"approx.ladder_ms", "approx.launch_us", "approx.retry_share"}
    assert not {m["name"] for m in harness.metrics_of(bench, SV, False)} & set(NEW)
    new = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    names = [m["name"] for m in bench["per_layer"]]
    at = names.index(NEW[0])
    assert set(new) == set(NEW) and names[at : at + len(NEW)] == list(NEW)  # in their order, one after another
    assert all(m["moves"] == "reads_per_s" for m in new.values())

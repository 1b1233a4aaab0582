"""The work-queue engine's four per-layer metrics: their readers on
hand-made records and reports, with their None cases; the one cell that
reads them; and their readers on the program's own tracer after a tiny
search of the work-queue cell's pool on the CPU."""

import pytest

from benchmark import harness, program_trace

CELL = "chr21-100bp-k2-workq.mapped"
WORKQ = ("workq.k5_launches", "workq.step_us", "workq.dedup_ms", "workq.queue_rows")
LAUNCHED = ("workq.k5_launches", "workq.step_us")  # they divide by K5's launch counter


def span(count, total_ms, self_ms):
    return dict(count=count, total_ms=total_ms, self_ms=self_ms)


def report(**over):
    rep = dict(
        calls=10,
        spans={"search": span(10, 9800.0, 30.0), "workq.search": span(530, 6000.0, 5460.0),
               "workq.dedup": span(10_600, 520.0, 480.0), "sync": span(54_590, 2100.0, 2100.0)},
        sites={"workq.step_counts": dict(count=54_590, total_ms=1530.0)},
        counters={"workq.queue_rows": 2_550_000_000, "workq.hit_intervals": 9_000_000},
        last_call=None, stages_ms={})
    rep.update(over)
    return rep


def record(**kw):
    rec = dict(reads_done=4_329_600, launches={"workq_step": 54_590, "workq_dedup": 10_600})
    rec.update(kw)
    return rec


def test_readers_on_a_report(read):
    rep, rec = report(), record()
    assert read("workq.k5_launches", rec, rep) == pytest.approx(54_590 / 4_329.6)
    assert read("workq.step_us", rec, rep) == pytest.approx(5460.0 * 1e3 / 54_590)
    assert read("workq.dedup_ms", rec, rep) == pytest.approx(480.0 / 4_329.6)
    assert read("workq.queue_rows", rec, rep) == pytest.approx(2_550_000_000 / 4_329.6)
    # K5's launch count is the program's counter, with a tracer or without one
    assert read("workq.k5_launches", rec, None) == pytest.approx(54_590 / 4_329.6)


@pytest.mark.parametrize("name", WORKQ)
def test_readers_read_nothing_where_nothing_fired(read, name):
    """No report (the program has no tracer, or no search had one), a span
    or counter that never fired, no K5 launch, no reads: None."""
    if name != "workq.k5_launches":
        assert read(name, record(), None) is None
        assert read(name, record(), report(spans={}, counters={})) is None
        never = report(spans={k: span(0, 0.0, 0.0) for k in report()["spans"]}, counters={"workq.queue_rows": 0})
        assert read(name, record(), never) is None
    if name in LAUNCHED:
        assert read(name, record(launches={"workq_step": 0}), report()) is None
        assert read(name, record(launches={}), report()) is None
    if name != "workq.step_us":  # a time a launch, not a rate a read
        assert read(name, record(reads_done=0), report()) is None


def test_only_the_work_queue_cell_reads_them(bench):
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in WORKQ}
    assert set(entries) == set(WORKQ)
    for m in entries.values():
        assert m["workloads"] == [CELL] and m["moves"] == "reads_per_s"
        assert m["layer"] == "work-queue engine (engine/workq.py)"
    for w in bench["workloads"]:
        read_here = {m["name"] for m in harness.metrics_of(bench, w["name"], True)} & set(WORKQ)
        assert read_here == (set(WORKQ) if w["name"] == CELL else set())
        assert not {m["name"] for m in harness.metrics_of(bench, w["name"], False)} & set(WORKQ)


def test_a_tiny_search_reads_the_spans_and_counters(bench, tiny, cache_dir):
    """The cell's pool at a tiny size through the benchmark's searcher under
    the program's tracer, as a traced window searches it: the dedup's time
    and the queue rows read numbers from the program's own report.  On the
    CPU the plain step runs and K5's launch counter stays 0, so the two
    metrics that divide by it read None there (the card test reads them)."""
    from sahara_tpu_torch import trace

    from benchmark import genome, reads, system

    cfg, mix = tiny(CELL)
    text = genome.load_text(cfg, cache_dir)
    index = system.upload(system.load_index(system.index_path(cfg, cache_dir, [text])), cfg, "cpu")
    pool = reads.make_pool(text, mix, 2**31 + 93)
    search = system.searcher(index, cfg, "cpu")
    timer = trace.StageTimer("cpu")
    before = system.launches()
    for batch in pool:
        search(batch, timer=timer)
    after = system.launches()
    rec = dict(reads_done=mix["batch_reads"] * len(pool),
               launches={name: after[name] - before.get(name, 0) for name in after})
    assert program_trace.report() == timer.report()
    got = {name: harness.reader(name)(rec) for name in WORKQ}
    rep = timer.report()
    assert got["workq.dedup_ms"] == pytest.approx(rep["spans"]["workq.dedup"]["self_ms"] / (rec["reads_done"] / 1e3))
    assert got["workq.queue_rows"] == pytest.approx(rep["counters"]["workq.queue_rows"] / (rec["reads_done"] / 1e3))
    assert got["workq.dedup_ms"] > 0 and got["workq.queue_rows"] > 1e3  # more than one queue row a read
    assert rec["launches"]["workq_step"] == 0 and got["workq.k5_launches"] is None and got["workq.step_us"] is None

"""The work-queue cell (``chr21-100bp-k2-workq.mapped``): which per-layer
metrics it reads; where its entries sit in ``BENCHMARK.json``; the
configuration's ``search`` section reaching the program's search
unchanged; and a tiny run of the cell on the CPU, correct, with the
engine's spans and counters on the program's own tracer."""

import numpy as np

from benchmark import harness, system

CELL = "chr21-100bp-k2-workq.mapped"
DRIVER = {"driver.merge_ms", "driver.sync_wait_ms", "driver.syncs"}


def test_the_cell_reads_every_metric_that_lists_no_cells(bench):
    """The kernels', the device's, the host's, the index's and the driver's
    metrics; none of another engine's."""
    traced = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert traced == {m["name"] for m in bench["per_layer"] if "workloads" not in m}
    assert DRIVER | {"kernels.device_ms", "device.idle_pct", "device.launches", "host.cpu_ms"} <= traced
    assert {m["name"] for m in harness.metrics_of(bench, CELL, False)} == {"reads_per_s", "setup_s"}


def test_the_new_entries_are_appended(bench):
    """The configuration and the cell come after every entry the benchmark
    had; no per-layer entry follows the driver's and the engines' last
    seven."""
    assert bench["configs"][-1]["name"] == "chr21-100bp-k2-workq"
    assert bench["workloads"][-1]["name"] == CELL and bench["workloads"][-1]["chips"] == 1
    assert bench["workloads"][-1]["config"] == "chr21-100bp-k2-workq" and bench["workloads"][-1]["traffic"] == "mapped"
    assert bench["per_layer"][-1]["name"] == "approx.retry_share"


def test_the_search_section_reaches_the_program_unchanged(bench, monkeypatch):
    from sahara_tpu_torch.engine import driver

    _, cfg, _ = harness.find_cell(bench, CELL)
    assert cfg["search"] == dict(engine="workq", generator_name="h2-k2", k=2, edit=True, mode="all", chunk=16384)
    assert cfg["upload"] == {"include_rev": True}
    seen = []

    def fake(index, queries, **kw):
        seen.append((index, queries, kw))
        return driver._empty()

    monkeypatch.setattr(driver, "search_queries", fake)
    queries = np.ones((4, 100), dtype=np.uint8)
    system.searcher("the index", cfg, "cpu")(queries, timer="the timer")
    (index, got, kw), = seen
    assert index == "the index" and got is queries
    assert kw == dict(cfg["search"], device="cpu", timer="the timer")


def test_a_tiny_run_is_correct_and_traced(bench, tiny, cache_dir):
    """The cell at a tiny size on the CPU with the program's plain kernels:
    correct; a search of the pool through the benchmark's searcher under
    the program's tracer closes the engine's spans and counts its rows."""
    from sahara_tpu_torch import trace

    cfg, mix = tiny(CELL)
    result, _ = harness.run(bench, CELL, seed=2**31 + 91, seconds=0.3, traced=False, device="cpu",
                            cache_dir=cache_dir, config=cfg, traffic=mix, log=lambda line: None)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0

    from benchmark import genome, reads

    text = genome.load_text(cfg, cache_dir)
    index = system.upload(system.load_index(system.index_path(cfg, cache_dir, [text])), cfg, "cpu")
    timer = trace.StageTimer("cpu")
    pool = reads.make_pool(text, mix, 2**31 + 92)
    for batch in pool:
        system.searcher(index, cfg, "cpu")(batch, timer=timer)
    rep = timer.report()
    assert rep["calls"] == len(pool) and rep["spans"]["driver.workq"]["count"] == len(pool)
    assert rep["spans"]["workq.search"]["count"] > 0 and rep["spans"]["workq.dedup"]["self_ms"] > 0
    assert rep["counters"]["workq.queue_rows"] > mix["batch_reads"] * len(pool)
    assert "workq.overflow_splits" not in rep["counters"]

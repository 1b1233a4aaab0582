"""A traced run of the work-queue cell on the card at a tiny size: it
builds, compares correct, reads every per-layer metric of the cell, and
its K5 launches and its count read-backs agree.  Skips without a CUDA card; run on the card with

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card_workq.py
"""

import pytest
import torch

from benchmark import harness, program_trace

pytestmark = pytest.mark.gpu

CELL = "chr21-100bp-k2-workq.mapped"


def test_a_traced_run_on_the_card(bench, tiny, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, mix = tiny(CELL, length=200_000, batch_reads=2048)
    result, record = harness.run(bench, CELL, seed=2**31 + 6, seconds=1.0, traced=True, device="cuda",
                                 cache_dir=str(tmp_path), config=cfg, traffic=mix, log=lambda line: None)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    want = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert set(result["metrics"]) == want
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]
    rep = program_trace.report()  # the traced window's tracer
    assert record["launches"]["workq_step"] == rep["sites"]["workq.step_counts"]["count"] > 0
    assert "workq.overflow_splits" not in rep["counters"]

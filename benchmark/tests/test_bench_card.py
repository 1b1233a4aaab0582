"""A traced run on the card at a tiny size: it builds, compares correct,
and reads every per-layer metric of its cell from the trace.  Skips
without a CUDA card; run on the card with

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["chr21-100bp-k2-sv.mapped", "chr21-100bp-k2-oss.mapped"])
def test_a_traced_run_on_the_card(bench, tiny, tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, mix = tiny(cell, length=200_000, batch_reads=2048)
    result, record = harness.run(bench, cell, seed=2**31 + 5, seconds=1.0, traced=True, device="cuda",
                                 cache_dir=str(tmp_path), config=cfg, traffic=mix, log=lambda line: None)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    want = {m["name"] for m in harness.metrics_of(bench, cell, True)}
    assert set(result["metrics"]) == want
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]

"""The metric arithmetic, the trace reading and the metric readers."""

import threading
import time

import numpy as np
import pytest

from benchmark import check, harness, stats, trace


def test_rate_is_all_work_over_the_whole_window():
    assert stats.rate(65536 * 3, 0.25) == 786432.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_thread_cpu_tells_the_main_thread_from_the_others():
    def spin(seconds):
        t0 = time.thread_time()
        while time.thread_time() - t0 < seconds:
            pass

    done = threading.Event()
    worker = threading.Thread(target=lambda: (spin(0.3), done.wait()))
    before = harness.thread_cpu()
    worker.start()
    while worker.is_alive() and not done.is_set() and sum(harness.thread_cpu().values()) < sum(before.values()) + 0.3:
        time.sleep(0.01)
    after = harness.thread_cpu()  # the worker still runs, so /proc still lists it
    done.set()
    worker.join()
    others = lambda cpu: sum(s for name, s in cpu.items() if name != "main")  # noqa: E731
    assert others(after) - others(before) >= 0.25
    assert after["main"] - before["main"] < 0.25


def test_union_counts_overlaps_once_and_clips_to_the_window():
    spans = [(0, 4), (2, 6), (5, 7), (10, 12), (11, 11.5), (20, 30), (-5, -1)]
    assert stats.union(spans, 1, 25) == [(1, 7), (10, 12), (20, 25)]
    assert stats.busy(spans, 1, 25) == 6 + 2 + 5
    assert stats.gaps(spans, 1, 25) == [(7, 10), (12, 20)]
    assert stats.gaps([], 0, 3) == [(0, 3)]
    assert stats.busy([(0, 1)], 2, 3) == 0


def events(window=(100.0, 1100.0)):
    lo, hi = window
    ev = [dict(ph="X", cat="user_annotation", name=trace.WINDOW, ts=lo, dur=hi - lo)]
    ev += [dict(ph="X", cat="kernel", name="void (anonymous namespace)::frontier_kernel<6, true>((anonymous "
                "namespace)::Params)", ts=200.0, dur=100.0),
           dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> Device)", ts=250.0, dur=100.0),
           dict(ph="X", cat="kernel", name="void at::native::reduce_kernel<512, 1>(int)", ts=600.0, dur=50.0),
           dict(ph="X", cat="kernel", name="frontier_kernel_v2(int)", ts=1050.0, dur=100.0),  # runs past the window
           dict(ph="X", cat="kernel", name="edit_kernel<2>(int)", ts=10.0, dur=5.0)]  # before it
    ev += [dict(ph="X", cat="python_function", name="/x/sahara_tpu_torch/engine/driver.py(123): _merge_results",
                ts=660.0, dur=380.0),
           dict(ph="X", cat="python_function", name="<built-in method lexsort of module object at 0x7f00>",
                ts=700.0, dur=300.0),
           dict(ph="X", cat="python_function", name="bench.py(1): outer", ts=100.0, dur=1000.0)]
    return ev


def test_summary_reads_the_window_only():
    s = trace.summarize(events())
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((150 + 50 + 50) * 1e-6)  # copy overlaps the kernel; last one clipped
    assert [name for name, _ in s["kernels"]] == [
        "void (anonymous namespace)::frontier_kernel<6, true>((anonymous namespace)::Params)",
        "void at::native::reduce_kernel<512, 1>(int)", "frontier_kernel_v2(int)"]
    assert s["top"][0] == ["frontier_kernel", pytest.approx(1e-4)]
    assert trace.summarize([e for e in events() if e["cat"] in ("user_annotation", "python_function")]) is None


def test_idle_gaps_go_to_the_innermost_host_function():
    idle = dict((name, s) for name, s in trace.idle_by_host(events()))
    # gaps: 100-200 and 350-600 under outer only, 650-1050 mostly under lexsort
    assert idle["<built-in method lexsort>"] == pytest.approx(400e-6)
    assert idle["bench.py(1): outer"] == pytest.approx(350e-6)


def record(**kw):
    rec = dict(reads_done=131072, window_s=2.0, cpu_s=1.5, batch_s=[0.1] * 19 + [0.5], setup_s=9.5,
               spans={"index.load_s": 0.15, "index.upload_s": 0.45}, launches={"frontier_step": 2060},
               stages_ms=None, trace=dict(reads=262144, window_s=0.5, busy_s=0.1, port_kernels=["frontier_kernel"],
                                          kernels=[["void (anonymous namespace)::frontier_kernel<6, true>(P)", 0.03],
                                                   ["at::native::frontier_kernel_helper(int)", 0.5],
                                                   ["void at::native::reduce_kernel<512>(int)", 0.01]]))
    rec.update(kw)
    return rec


def test_readers(bench):
    read = {m["name"]: harness.reader(m["name"]) for m in bench["end_to_end"] + bench["per_layer"]}
    rec = record()
    assert read["reads_per_s"](rec) == 65536.0
    assert read["setup_s"](rec) == 9.5
    assert read["kernels.device_ms"](rec) == pytest.approx(30.0 / 262.144)
    assert read["device.idle_pct"](rec) == pytest.approx(80.0)
    assert read["device.launches"](rec) == pytest.approx(3 / 262.144)
    assert read["approx.k8_launches"](rec) == pytest.approx(2060 / 131.072)
    assert read["index.load_s"](rec) == 0.15 and read["index.upload_s"](rec) == 0.45
    assert read["host.cpu_ms"](rec) == pytest.approx(1500 / 131.072)
    # nothing to read: no stage timer, no K8 launch, no trace
    assert read["sv.stage_ms"](rec) is None
    assert read["sv.stage_ms"](record(stages_ms=dict(seed=0.0, verify=0.0))) is None
    assert read["sv.stage_ms"](record(stages_ms=dict(seed=10.0, verify=3.1))) == pytest.approx(13.1 / 131.072)
    assert read["approx.k8_launches"](record(launches={"frontier_step": 0})) is None
    assert read["host.cpu_ms"](record(reads_done=0)) is None
    for name in ("kernels.device_ms", "device.idle_pct", "device.launches"):
        assert read[name](record(trace=None)) is None


def test_each_cell_reads_its_own_metrics(bench):
    names = lambda cell, traced: [m["name"] for m in harness.metrics_of(bench, cell, traced)]  # noqa: E731
    assert names("chr21-100bp-k2-sv.mapped", False) == ["reads_per_s", "setup_s"]
    assert "sv.stage_ms" in names("chr21-100bp-k2-sv.mapped", True)
    assert "approx.k8_launches" not in names("chr21-100bp-k2-sv.mapped", True)
    assert "sv.stage_ms" not in names("chr21-100bp-k2-oss.hostdep", True)
    assert "approx.k8_launches" in names("chr21-100bp-k2-oss.mapped", True)


def test_judge_counts_every_answer():
    want = [{k: np.asarray(v) for k, v in dict(query=[0, 0, 3], seq=[0, 0, 0], pos=[5, 9, 2], errors=[1, 2, 0]).items()}]
    good = {k: v.copy() for k, v in want[0].items()}
    bad = {k: v.copy() for k, v in want[0].items()}
    bad["errors"][1] = 1
    short = {k: v[:2] for k, v in want[0].items()}
    twice = {k: np.concatenate([v, v[:1]]) for k, v in want[0].items()}
    n = check.judge(want, [(0, good), (0, bad), (0, good), (0, short), (0, None), (0, twice), (0, bad)])
    assert n == dict(missing_rows=1, extra_rows=1, wrong_errors=2, unanswered_batches=1)
    assert not check.verdict(n) and check.verdict(check.judge(want, [(0, good)] * 3))

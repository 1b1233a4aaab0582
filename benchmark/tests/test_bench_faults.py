"""A run on the CPU at a tiny size, with the program's plain kernels: sound
it comes out correct; with the timed path broken underneath, or the
control in the program's place, it does not."""

import numpy as np
import pytest

from benchmark import control, harness, reference

CELL = "chr21-100bp-k2-sv.mapped"


def run(bench, tiny, cache_dir, cell=CELL, wrap=None, seconds=0.3):
    cfg, mix = tiny(cell)
    return harness.run(bench, cell, seed=2**31 + 77, seconds=seconds, traced=False, device="cpu",
                       cache_dir=cache_dir, config=cfg, traffic=mix, wrap=wrap, log=lambda line: None)


def rows_where(rows, keep):
    return {k: v[keep] for k, v in rows.items()}


def half_left_out(search):
    def broken(queries, timer=None):
        rows = search(queries, timer=timer)
        return rows_where(rows, rows["query"] < len(queries) // 2)
    return broken


def one_answer_altered(search):
    calls = []

    def broken(queries, timer=None):
        rows = search(queries, timer=timer)
        calls.append(1)
        if len(calls) == 5:  # the window's third answer: its first pool batch's second visit
            rows = {k: v.copy() for k, v in rows.items()}
            rows["pos"][len(rows["pos"]) // 2] += 1
        return rows
    return broken


def previous_answer(search):
    last = []

    def broken(queries, timer=None):
        rows = search(queries, timer=timer)
        out = last[0] if last else rows
        last[:] = [rows]
        return out
    return broken


def refuses(search):
    def broken(queries, timer=None):
        raise RuntimeError("buffers still overflow")
    return broken


@pytest.mark.parametrize("cell", ["chr21-100bp-k2-sv.mapped", "chr21-100bp-k2-oss.hostdep"])
def test_a_sound_run_is_correct(bench, tiny, cache_dir, cell):
    result, record = run(bench, tiny, cache_dir, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(result)[-1] == "checks" and all(c["value"] == 0 for c in result["checks"].values())
    assert len(record["batch_s"]) >= 1


@pytest.mark.parametrize("fault", [half_left_out, one_answer_altered, previous_answer, refuses])
def test_a_broken_path_is_not_correct(bench, tiny, cache_dir, fault):
    result, record = run(bench, tiny, cache_dir, wrap=fault, seconds=1.0)
    assert not result["correct"] and len(record["batch_s"]) >= 3


def test_the_control_is_not_correct(bench, tiny, cache_dir):
    """The reference at k - 1 in the program's place, through a whole run
    and through the control's own script."""
    cfg, mix = tiny(CELL)
    k = cfg["search"]["k"]

    def reference_at_k_minus_1(search):
        def answer(queries, timer=None):
            text = control_text[0]
            return reference.hits(reference.Text([text], reference.g_for(queries.shape[1], k), "cpu"), queries, k - 1)
        return answer

    from benchmark import genome
    control_text = [genome.load_text(cfg, cache_dir)]
    result, _ = run(bench, tiny, cache_dir, wrap=reference_at_k_minus_1)
    assert not result["correct"] and result["checks"]["missing_rows"]["value"] > 0
    numbers = control.control_numbers(cfg, mix, 2**31 + 78, "cpu", cache_dir)
    assert numbers["missing_rows"] > 0 and numbers["extra_rows"] == 0 and numbers["wrong_errors"] == 0


def test_hit_rows_reach_the_comparison(bench, tiny, cache_dir):
    """The sound run compares rows, not empty answers."""
    seen = []

    def spy(search):
        def answer(queries, timer=None):
            rows = search(queries, timer=timer)
            seen.append(len(rows["query"]))
            return rows
        return answer

    result, _ = run(bench, tiny, cache_dir, wrap=spy)
    assert result["correct"] and min(seen) >= 40 and np.mean(seen) > 40

"""The four-card cell amp700-b256-x4 on the CPU: a short run of its
entry kind (``batch_x4`` over ``devices=["cpu"] * 4``) against the plain
reference, and the readers of its per-card metrics."""
import pytest

from consbench import run
from consbench.drivers import batch_x4
from consbench.measure import Call, Window

CELL = "amp700-b256-x4"
X4 = ("card_busy_share.x4", "card_imbalance.x4", "launch_skew_ms.x4")


def small_traffic():
    """The cell's traffic cut to its first 8 clusters at an eighth of
    their length and at most 4 reads: the plain versions of the loop's
    kernels take about a minute a 650 bp cluster on one core."""
    _wl, _config, traffic = run.cell_spec(run.load_json(
        run.ROOT / "BENCHMARK.json"), CELL)
    return dict(traffic, batches=2, check_clusters=4,
                schedule=[[length // 8, min(depth, 4)]
                          for length, depth in traffic["schedule"][:8]])


def test_cell_on_four_cpu_entries_is_correct():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    wl, config, traffic = run.cell_spec(bench, CELL)
    assert wl["chips"] == batch_x4.CARDS == 4
    assert traffic["driver"] == "batch_x4" and len(traffic["schedule"]) == 256
    result, window, checks = run.run_cell(
        wl, config, small_traffic(), 2**31 + 77, 0.1, False, "cpu",
        workers=1)
    assert result["correct"] and result["failed"] == 0
    assert checks["checked_answers"] == 4
    for c in window.calls:
        assert c.counters["fallbacks"] == 0
        # a contiguous quarter of the 8 live clusters a card
        assert [c.counters[f"instances.{i}"] for i in range(4)] == [2] * 4
        assert all(c.counters[f"busy_s.{i}"] > 0 for i in range(4))
        assert all(c.counters[f"launched_s.{i}"] >= 0 for i in range(4))
    for name in X4:
        assert run.read_metric(name, window) > 0


def window(busy, launched, with_cards=True):
    calls = []
    for t, (b, s) in enumerate(zip(busy, launched)):
        counters = {"fallbacks": 0, "dp_cells": 10}
        if with_cards:
            for i, (bi, si) in enumerate(zip(b, s)):
                counters.update({f"instances.{i}": 64, f"busy_s.{i}": bi,
                                 f"launched_s.{i}": si})
        else:
            counters.update({f"instances.{i}": 64 for i in range(4)})
        calls.append(Call(2.0 * t, 2.0 * t + 2.0, [(0, t)], [["A"]],
                          counters))
    return Window(calls, 1.0, 3)


def test_readers_read_the_per_card_counters():
    w = window([[0.1, 0.2, 0.3, 0.2], [0.2, 0.2, 0.2, 0.2]],
               [[0.01, 0.02, 0.03, 0.04], [0.0, 0.01, 0.01, 0.005]])
    # the cards' mean of 0.4 busy seconds over 4 s of window
    assert run.read_metric("card_busy_share.x4", w) == pytest.approx(0.1)
    # 0.3 / 0.2 in the first call, 1 in the second
    assert run.read_metric("card_imbalance.x4", w) == pytest.approx(1.25)
    assert run.read_metric("launch_skew_ms.x4", w) == pytest.approx(20.0)


@pytest.mark.parametrize("name", X4)
def test_readers_give_none_without_the_per_card_counters(name):
    """A port whose BatchPOA.shards has only device and instances (the
    parent's) yields no value and does not raise."""
    w = window([[0.1] * 4] * 2, [[0.0] * 4] * 2, with_cards=False)
    assert run.read_metric(name, w) is None

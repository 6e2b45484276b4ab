"""The device's busy time as the union of overlapping intervals, its idle
gaps, and the breakdown named by the benchmark's spans."""

import pytest

from perfbench.trace import WINDOW, Trace, idle_gaps, union_seconds


def test_union_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.7), (5.0, 6.0), (5.5, 7.5)]
    assert union_seconds(iv, 0.0, 10.0) == pytest.approx(3.0 + 2.5)
    assert union_seconds(iv, 1.5, 5.5) == pytest.approx(1.5 + 0.5)
    assert union_seconds([], 0.0, 1.0) == 0.0


def test_idle_gaps():
    iv = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0)]
    assert idle_gaps(iv, 0.0, 6.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]


def test_trace_busy_idle_and_breakdown():
    ops = [(1.0, 2.0, "k_a"), (1.5, 2.5, "k_b"), (3.0, 4.0, "k_a"), (9.0, 11.0, "k_c")]
    spans = [(0.5, 10.0, WINDOW), (0.6, 2.8, "perfbench.tick"), (2.8, 5.0, "perfbench.tick"),
             (5.0, 9.5, "perfbench.wait")]
    tr = Trace(ops, spans)
    assert tr.window_s == pytest.approx(9.5)
    assert tr.busy_s() == pytest.approx(1.5 + 1.0 + 1.0)
    assert tr.op_seconds(lambda n: n == "k_a") == pytest.approx(2.0)
    b = tr.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k_a", "k_b", "k_c"]
    assert b["idle_gaps"][0] == ["perfbench.tick", pytest.approx(5.0)]
    assert sorted(n for n, _ in b["idle_gaps"][1:]) == ["outside spans", "perfbench.tick"]
    assert [s for _, s in b["idle_gaps"][1:]] == [pytest.approx(0.5)] * 2

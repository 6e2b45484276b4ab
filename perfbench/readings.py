"""Arithmetic that several per-layer readers share (perfbench/metrics/).
A reader returns None where the run gives it nothing to read."""

from __future__ import annotations

from perfbench import work


def unit_work(reading) -> work._Count:
    """The counted work of one unit of the window (a call, a step or a tick)."""
    u = reading.measured["unit"]
    if u["kind"] == "train":
        return work.train_step_flops(reading.cell.cfg, reading.cell.cfg["recipe"], u["batch"],
                                     u["samples"])
    return work.call_flops(reading.cell.cfg, u["batch"], u["samples"])


def mfu(reading):
    """% of the H100's bf16 peak: the window's counted FLOPs over its time."""
    m = reading.measured
    if not m["units"]:
        return None
    flop = m["units"] * unit_work(reading).flop
    return 100.0 * flop / m["window_s"] / work.H100_PEAK_FLOPS


def idle_share(reading):
    """% of the traced window in which no operation ran on the card."""
    tr = reading.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)

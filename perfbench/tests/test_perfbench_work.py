"""The frozen counts: attention by its formula, and whole calls and steps
of the plain reference on the meta device, at small sizes."""

import json
import os

from perfbench import work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    with open(os.path.join(ROOT, "configs", "cmgan_16k.json")) as f:
        return json.load(f)


def test_attention_work_by_hand():
    # T 8, max_pos 3: 34 near pairs (|i - j| < 3) and 30 clipped
    fwd = work.attention_work(2, 8, 8, 8, 0, 3, 4, 4)
    assert (fwd["near"], fwd["far"]) == (34, 30)
    assert fwd["flop"] == 2 * 4 * 2 * (3 * 34 + 2 * 30) == 2592
    assert fwd["bytes"] == 4 * 4 * (2 * 16 + 2 * 16 + 7) == 1136
    bwd = work.attention_work(2, 8, 8, 8, 0, 3, 4, 4, backward=True)
    assert bwd["flop"] == 16 * (8 * 34 + 5 * 30) and bwd["bytes"] == 2336


def test_roofline_seconds_takes_the_longer_bound():
    assert work.roofline_seconds({"flop": 989e12, "bytes": 0}) == 1.0
    assert work.roofline_seconds({"flop": 0, "bytes": 3.35e12}) == 1.0


def test_call_flops_fixed():
    count = work.call_flops(_cfg(), 1, 1600)
    assert count.flop == 6928201522
    assert count.attention == [(404, 17, 16, False), (68, 101, 16, False)] * 4


def test_train_step_flops_fixed():
    cfg = _cfg()
    count = work.train_step_flops(cfg, cfg["recipe"], 2, 8000)
    assert count.flop == 338684589522
    assert count.attention == [(808, 81, 16, True), (648, 101, 16, True)] * 4

"""On the card: each cell's lower-precision control (the program with TF32
on for its float32 products) comes out not correct, and the program on
the same seed comes out correct, at the cell's own size with a short
window. Run with `python3 -m pytest perfbench/tests -m card -q`."""

import pytest

from perfbench import run

CELLS = [w["name"] for w in run.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(card, cell):
    program = run.run_cell(cell, 77, 1.0, False)
    control = run.run_cell(cell, 77, 1.0, False, tf32=True)
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]

"""the control: the plain reference computed with every operand rounded to
float8 e4m3, one step below the configuration's bfloat16, put in the
program's place. At the tiny size on the CPU it reads at least three
times the program's bfloat16 readings on some number, and fails the
cell's limits; on the card, `calibrate.py` reads it at the cell's size."""

from __future__ import annotations

import math

from benchmark import calibrate
from benchmark.tests import tiny


def test_control_separates_from_the_program():
    cell = tiny.cell("bfloat16")
    got = calibrate.readings(cell, 77, 0.2, device="cpu")
    prog, ctl = got["program"], got["control"]
    ratios = {k: ctl[k] / prog[k] for k in prog if prog[k] > 0}
    assert max(ratios.values()) >= 3.0, (prog, ctl)
    assert any(ctl[k] > cell.limits[k] for k in ctl if math.isfinite(cell.limits[k])), (ctl, cell.limits)

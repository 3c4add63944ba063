"""The controls on the card, at the cells' own sizes with short windows:
the program with TF32 products switched on, and the reference computed in
bfloat16 in the program's place, must each come out not correct; a sound
run must come out correct.

    python3 -m pytest perfbench/tests/test_perfbench_control.py -q -m cuda
"""

import pytest
from conftest import bench

from perfbench.run import run_cell

WINDOW = {"scan-fma_full-v2": 10, "query-fma_large-v2": 20}


@pytest.mark.cuda
@pytest.mark.parametrize("cell, control", [
    ("scan-fma_full-v2", "tf32"),
    ("scan-fma_full-v2", "bf16"),
    ("query-fma_large-v2", "tf32"),
])
def test_the_control_is_not_correct(card, cell, control):
    r = run_cell(cell, 3_000_000_001, WINDOW[cell], False, control=control, bench=bench())
    assert r["correct"] is False, r["checked"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(WINDOW))
def test_a_sound_run_is_correct(card, cell):
    r = run_cell(cell, 3_000_000_002, WINDOW[cell], False, bench=bench())
    assert r["correct"] is True, r["checked"]

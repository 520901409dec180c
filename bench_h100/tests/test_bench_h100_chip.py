"""On the card, at each cell's own size: one job of the program is correct
by the cell's limits, and the fp8 control (the reference one precision
below the configuration's, in the program's place) is not.  Skips without
a card.  A few minutes a cell."""

import time

import pytest

from bench_h100 import check, harness

SEEDS = {"t2v_camera.b2": 2 ** 31 + 401, "i2v_rgb.b1": 2 ** 31 + 402}


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(SEEDS))
def test_the_program_passes_and_the_control_fails_at_the_cells_size(cell, card):
    c = harness.load_cell(cell)
    out = harness.run(c, SEEDS[cell], 0.0, False, card, time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert not check.verdict(out["control"], c.limits), out["control"]

"""The control: the plain reference computed in float32, the precision
below the configuration's float64, put in the program's place, comes out
not correct (on the chip at the cells' own sizes: stencil_bench/
calibrate.py; here at 32²)."""

from __future__ import annotations

import time

import pytest

from stencil_bench import run
from stencil_bench.tests import helpers


@pytest.mark.parametrize("seed", [31, 32, 2 ** 31 + 33])
def test_float32_in_the_programs_place_is_not_correct(seed):
    _, line = run.execute(helpers.small_cell(helpers.PERF), seed, 0.2, False, device="cpu",
                          t_start=time.time(), rank_fn=helpers.control_rank)
    check = line["checks"]["err_over_change"]
    assert line["correct"] is False and check["value"] > 3 * check["limit"]

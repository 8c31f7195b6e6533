"""The harness's whole run, with the look for a card skipped and the
timed path broken underneath, comes out not correct: once for each fault
the cells can have."""

from __future__ import annotations

import functools
import time

import pytest

from stencil_bench import run
from stencil_bench.tests import helpers


@pytest.mark.parametrize("fault", ["unchanged", "half_field", "altered"])
def test_perf_fault_is_not_correct(fault):
    rank_fn = functools.partial(helpers.faulty_rank, fault=fault)
    _, line = run.execute(helpers.small_cell(helpers.PERF), 21, 0.2, False, device="cpu",
                          t_start=time.time(), rank_fn=rank_fn)
    assert line["correct"] is False and line["failed"] == 1
    check = line["checks"]["err_over_change"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("fault", helpers.FAULTS)
def test_hide_fault_on_two_gloo_ranks_is_not_correct(fault):
    rank_fn = functools.partial(helpers.faulty_rank, fault=fault)
    _, line = run.execute(helpers.small_hide(), 22, 0.2, False, device="cpu",
                          t_start=time.time(), rank_fn=rank_fn)
    assert line["correct"] is False
    check = line["checks"]["err_over_change"]
    assert check["value"] > check["limit"]


def test_a_state_left_unchanged_reads_one():
    rank_fn = functools.partial(helpers.faulty_rank, fault="unchanged")
    _, line = run.execute(helpers.small_cell(helpers.PERF), 23, 0.2, False, device="cpu",
                          t_start=time.time(), rank_fn=rank_fn)
    assert line["checks"]["err_over_change"]["value"] == pytest.approx(1.0)

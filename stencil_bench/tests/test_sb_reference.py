"""At 32², the plain reference against the program's CPU path (the
kernels' plain versions): `perf` on one rank and `hide` on two gloo
ranks, through the harness's whole run; and the pieces the check rests
on: inputs that do not depend on the block asked for, and a margin block
that steps a shard exactly."""

from __future__ import annotations

import time

import pytest
import torch

from stencil_bench import run
from stencil_bench.inputs import diffusion2d as inputs
from stencil_bench.reference import diffusion as reference
from stencil_bench.tests import helpers

IC = {"centre_jitter": 0.25, "noise_amplitude": 0.01}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_perf_matches_the_reference(seed):
    ranks, line = run.execute(helpers.small_cell(helpers.PERF), seed, 0.2, False,
                              device="cpu", t_start=time.time())
    assert line["correct"] is True
    assert line["checks"]["err_over_change"]["value"] < 1e-13
    assert ranks[0]["readings"]["max_moved"] > 1e-3


def test_hide_on_two_gloo_ranks_matches_the_reference():
    ranks, line = run.execute(helpers.small_hide(), 17, 0.2, False, device="cpu",
                              t_start=time.time())
    assert len(ranks) == 2 and line["correct"] is True
    assert line["checks"]["err_over_change"]["value"] < 1e-13
    assert all(r["route"] == "scan-loop" for r in ranks)


def test_inputs_do_not_depend_on_the_block():
    vec = inputs.make_vectors(9, (40, 36), (10.0, 10.0), IC, 1.0, "cpu")
    whole = inputs.make_T0(vec, (slice(0, 40), slice(0, 36)))
    part = inputs.make_T0(vec, (slice(7, 29), slice(3, 20)))
    assert torch.equal(whole[7:29, 3:20], part)
    cp = inputs.make_Cp(vec, (slice(0, 40), slice(0, 36)))
    assert torch.equal(cp[7:29, 3:20], inputs.make_Cp(vec, (slice(7, 29), slice(3, 20))))
    assert float(cp.min()) >= 1.0
    other = inputs.make_vectors(10, (40, 36), (10.0, 10.0), IC, 1.0, "cpu")
    assert not torch.equal(whole, inputs.make_T0(other, (slice(0, 40), slice(0, 36))))


def test_a_margin_block_steps_its_shard_exactly():
    shape, steps = (48, 40), 6
    spacing = (10.0 / 48, 10.0 / 40)
    vec = inputs.make_vectors(4, shape, (10.0, 10.0), IC, 1.0, "cpu")
    full = (slice(0, 48), slice(0, 40))
    dt = reference.time_step(spacing, 1.0, 1.0)
    R = reference.run(inputs.make_T0(vec, full), inputs.make_Cp(vec, full), steps, 1.0, dt,
                      spacing)
    shard = (slice(24, 48), slice(0, 20))
    block, inner = reference.margin_region(shard, shape, steps)
    assert block == (slice(18, 48), slice(0, 26))
    Rb = reference.run(inputs.make_T0(vec, block), inputs.make_Cp(vec, block), steps, 1.0,
                       dt, spacing)
    torch.testing.assert_close(Rb[inner], R[shard], rtol=0, atol=1e-15)
    # One step more and the cut's error reaches the shard.
    Rb2 = reference.run(inputs.make_T0(vec, block), inputs.make_Cp(vec, block), steps + 1,
                        1.0, dt, spacing)
    R2 = reference.run(inputs.make_T0(vec, full), inputs.make_Cp(vec, full), steps + 1, 1.0,
                       dt, spacing)
    assert float((Rb2[inner] - R2[shard]).abs().max()) > 1e-12


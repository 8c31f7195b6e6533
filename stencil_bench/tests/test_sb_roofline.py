"""The roofline byte counts against hand counts, and the readers that
reduce a trace, on hand-made intervals."""

from __future__ import annotations

import pytest

from stencil_bench import registry, trace, units
from stencil_bench.report import Context
from stencil_bench.roofline import fused_step_cm, masked_step, peaks


def test_masked_step_bytes_by_hand():
    # 4 x 5 cells, f64: read T (160 B) and Cm (160 B), write the new T (160 B).
    assert masked_step.bytes_per_launch((4, 5), 8) == 480
    assert masked_step.bytes_per_launch((12288, 12288), 8) == 3 * 12288 * 12288 * 8


@pytest.mark.parametrize("coords, dims, faces", [
    ((0, 0), (1, 1), 0),            # one rank: every face a domain edge
    ((0, 0), (2, 2), 6 + 4),        # a corner of 2x2: one face across each axis
    ((1, 1), (3, 3), 2 * 6 + 2 * 4),  # the middle of 3x3: all four faces
    ((1, 0), (3, 1), 2 * 6),        # a middle row of 3x1: two faces across axis 0
])
def test_fused_step_cm_bytes_by_hand(coords, dims, faces):
    # A 4 x 6 shard: a face across axis 0 holds 6 cells, across axis 1 4.
    assert fused_step_cm.face_cells((4, 6), coords, dims) == faces
    assert fused_step_cm.bytes_per_step((4, 6), 8, coords, dims) == (3 * 24 + faces) * 8


def test_interval_algebra():
    assert trace.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert trace.measure([(0, 1), (0.5, 2), (5, 6)]) == 3
    assert trace.intersect([(0, 2), (3, 5)], [(1, 4)]) == 2
    data = trace.TraceData(t0=0.0, t1=10.0, steps=2, device=[
        trace.Event("k", "kernel", 1.0, 2.0), trace.Event("k", "kernel", 1.5, 3.0),
        trace.Event("c", "gpu_memcpy", 6.0, 7.0)], host=[
        trace.Event("cudaGraphLaunch", "cuda_runtime", 3.0, 6.0),
        trace.Event("outer", "cpu_op", 0.0, 10.0)])
    assert data.busy_s() == 3.0 and data.kernels() == 2
    assert data.gaps() == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]
    assert data.host_at(4.5) == "cudaGraphLaunch"
    rows = trace.breakdown([data])
    assert rows["device_ops"] == [["k", 2.5], ["c", 1.0]]  # summed, not unioned
    assert rows["idle_gaps"][0] == ["cudaGraphLaunch", 3.0]


def test_a_slice_runs_from_its_first_device_event_to_its_last(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": trace.SLICE_NAME, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 10,
         "args": {"stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5, "dur": 3},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50}]}
    path = tmp_path / "t.json"
    path.write_text(__import__("json").dumps(doc))
    data = trace.parse(path)
    assert (data.t0, data.t1) == pytest.approx((10e-6, 40e-6))
    assert data.busy_s() == pytest.approx(20e-6) and data.kernels() == 1
    assert data.host[1].name == "cudaGraphLaunch"
    assert trace.short_name("void (anonymous namespace)::rmt_masked_step_kernel<double, 2,"
                            " false>(double const*, double*)") == \
        "rmt_masked_step_kernel<double, 2, false>"


def _ctx(workload, events, steps, shape, coords=(0, 0), dims=(1, 1)):
    cell = registry.cell(workload)
    data = trace.TraceData(t0=0.0, t1=1.0, steps=steps, device=events, host=[])
    rank = {"trace": data, "local_shape": shape, "itemsize": 8, "coords": coords,
            "dims": dims, "capture_s": 0.25, "runs": 1, "steps_per_run": steps,
            "window_s": 1.0, "global_shape": shape, "setup_s": 3.0, "peak_bytes": 2 ** 30,
            "run_device_s": 0.5 * steps}
    return cell, Context(cell=cell, ranks=[rank], on_device=True)


def test_roofline_readers_by_hand():
    # Two steps of a 1000 x 1000 f64 field, each masked_step launch 10 us:
    # 24 MB a launch at 3.35 TB/s is 7.164 us, 71.64 % of 10 us.
    events = [trace.Event("void rmt_masked_step_kernel<double, 2, false>(...)", "kernel",
                          0.1 + i * 1e-3, 0.1 + i * 1e-3 + 10e-6) for i in range(2)]
    cell, ctx = _ctx("diff2d-perf-f64-12288", events, 2, (1000, 1000))
    got = cell.reader("masked_step_roofline")(ctx)
    assert got == pytest.approx(100 * 24e6 / peaks.HBM_BYTES_PER_S / 10e-6)
    # Two launches of 10 us each.
    assert cell.reader("masked_step.launch_us")(ctx) == pytest.approx(10.0)
    # A run of two steps takes 1 s of device time untraced (CUDA events),
    # 20 us of it busy: the rest is the gap, a kernel's share.
    assert cell.reader("driver.gap_us")(ctx) == pytest.approx((1.0 - 20e-6) / 2 * 1e6)
    # The hide step's boxes overlap in time: the union counts, once.
    boxes = [trace.Event("rmt_fused_step_cm_kernel", "kernel", 0.1, 0.1 + 8e-6),
             trace.Event("rmt_fused_step_cm_kernel", "kernel", 0.1 + 2e-6, 0.1 + 10e-6),
             trace.Event("ncclDevKernel_SendRecv", "kernel", 0.1 + 1e-6, 0.1 + 12e-6)]
    cell, ctx = _ctx("diff2d-hide-f64-2x2-12288", boxes, 1, (1000, 1000), (0, 0), (2, 2))
    need = (3 * 10 ** 6 + 2000) * 8
    assert cell.reader("fused_step_cm_roofline")(ctx) == pytest.approx(
        100 * need / peaks.HBM_BYTES_PER_S / 10e-6)
    assert cell.reader("halo.nccl_ms_per_step")(ctx) == pytest.approx(11e-3)
    assert cell.reader("overlap.exposed_comm_ms_per_step")(ctx) == pytest.approx(2e-3)
    assert cell.reader("device.idle_pct")(ctx) == pytest.approx(100 * (1 - 12e-6 / 0.5))
    assert cell.reader("driver.capture_ms")(ctx) == pytest.approx(250.0)
    # No kernel of that name in the slice: nothing to read, never 0.
    assert cell.reader("masked_step_roofline")(ctx) is None
    assert cell.reader("masked_step.launch_us")(ctx) is None


def test_frozen_rate_arithmetic():
    assert units.wtime_per_it(10.0, 1000, 0) == 0.01
    assert units.gpts_per_s((1000, 2000), 0.01) == pytest.approx(0.2)
    with pytest.raises(ValueError):
        units.wtime_per_it(1.0, 10, 10)

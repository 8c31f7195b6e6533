"""The port's multichip dry run (rocm_mpi_tpu_torch/entry.py
`dryrun_multichip`), the twin of `__graft_entry__.dryrun_multichip`, on 8
and 4 gloo ranks on the CPU: every leg held against the host-staged oracle
or the `ap` referee, the checkpoint leg's crash-resumed run bitwise the
straight one, `dryrun_multichip ok` printed, and the CPU legs launch no
kernel."""

import pytest

from rocm_mpi_tpu_torch.entry import dryrun_multichip


@pytest.mark.parametrize("n,dims,dims3", [(8, (4, 2), (2, 2, 2)), (4, (2, 2), (2, 2, 1))])
def test_dryrun_multichip_on_cpu_ranks(n, dims, dims3, capsys):
    reports = dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip ok: {n} CPU ranks (gloo), grid {dims}" in out
    assert f"3D grid {dims3}" in out and "clamped to (8, 4)" in out
    assert "checkpoint/resume: perf segmented with per-rank saves every 2 steps" in out
    assert "not ported yet" not in out
    assert [r["rank"] for r in reports] == list(range(n))
    for r in reports:
        assert r["b_width"] == (8, 4)
        assert r["hbm_route"] == "hbm-tb" and r["routes"]["deep"] == "vmem"
        assert r["swe_mass_drift"] <= 1e-6
        assert r["ckpt_latest"] == 4
        assert {"ap", "kp", "perf", "hide", "deep", "hbm", "wave-perf", "swe-deep",
                "3d-hide", "wave-3d-deep", "swe-3d-deep", "checkpoint"} <= set(r["launches"])
        assert all(set(c.values()) == {0} for c in r["launches"].values())


def test_dryrun_multichip_defaults_to_the_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)

"""Port, the preflight check (``sim/preflight.py``) on the CPU.

- ``--cpu --ports``: every check passes but the solve, which is not asked
  for; the AOT check of the JAX tool is reported as not ported;
- ``--cpu --solve``: one plain solve of ``iris_traj_mpc.yaml`` through
  ``mpc_fn`` (no kernel launch on the CPU);
- without ``--cpu`` and without a card: the device check FAILs and the exit
  code counts it (and the solve on the card, when asked for, fails too);
- a library without the router symbols FAILs the native check.
"""
import socket

import torch

from sde4mbrl_px4_tpu_torch.sim import preflight as PF


def _free() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_preflight_cpu_passes(capsys, monkeypatch):
    monkeypatch.setattr(PF, "SITL_PORTS", tuple(_free() for _ in range(3)))
    assert PF.main(["--cpu", "--ports"]) == 0
    out = capsys.readouterr().out
    for name in ("python deps", "native runtime", "MPC configs + checkpoints", "trajectories",
                 "device", "UDP ports"):
        assert f"  ok    {name}" in out, out
    assert "end-to-end solve" not in out and "PREFLIGHT PASS" in out
    assert "committed AOT artifacts" in out and "not checked" in out
    assert "7 configs, 2 checkpoints" in out


def test_preflight_cpu_solve_runs_one_plain_solve(capsys):
    assert PF.main(["--cpu", "--solve"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "end-to-end solve" in ln)
    assert line.startswith("  ok") and "on cpu" in line and "0 apg_solve launches" in line


def test_preflight_without_card_counts_the_device_failure(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PF.main([]) == 1
    out = capsys.readouterr().out
    assert "  FAIL  device" in out and "no CUDA card" in out and "PREFLIGHT: 1 FAILURE(S)" in out
    assert PF.main(["--solve"]) == 2
    assert "  FAIL  end-to-end solve" in capsys.readouterr().out


def test_preflight_flags_a_stale_native_library(capsys, monkeypatch):
    from sde4mbrl_px4_tpu_torch.io import mavlink

    class Stale:
        mav_frame_decode = geo_control_update = mbx_open = object()

    monkeypatch.setattr(mavlink, "load_native", lambda: Stale())
    assert PF.main(["--cpu"]) == 1
    out = capsys.readouterr().out
    assert "  FAIL  native runtime" in out and "router_new" in out
    monkeypatch.setattr(mavlink, "load_native", lambda: None)
    assert PF.main(["--cpu"]) == 1
    assert "make -C csrc" in capsys.readouterr().out


def test_preflight_counts_a_missing_config_dir(tmp_path, capsys):
    assert PF.main(["--cpu", "--config-dir", str(tmp_path / "missing")]) == 1
    out = capsys.readouterr().out
    assert "  FAIL  MPC configs + checkpoints" in out and "no *_mpc.yaml" in out

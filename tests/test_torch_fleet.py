"""The port's fleet serving engine (L6) on the CPU, mirroring
``tests/test_fleet.py``: ``parallel/fleet.py::FleetEngine`` (B vehicles per
tick, one batched solve each) and ``sim/fleet_serving.py`` (the port's
``examples/fleet_serving.py``).

- pipelined ticks: the cold tick returns its own plans at age 0, the next
  ones the previous tick's at age > 0 (the cold tick's plans come back one
  tick later);
- ``u_now`` (B, n_u) inside the motor box, ``x_evol`` (B, H+1, 13);
- blocking ticks are the batched solve of the same inputs, bit for bit;
- four vehicles with their own targets close on them over a short run
  (the plant is the model's own prediction, ``x_evol[:, 1]``);
- the fleet demo runs on the CPU and prints its numbers, with ``--solver
  mppi`` and ``--solver policy`` too (the hybrid, on the shipped
  checkpoint); the engine's default device is the card.
"""
import copy
import os

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc
from sde4mbrl_px4_tpu_torch.parallel.fleet import FleetEngine
from sde4mbrl_px4_tpu_torch.sim import fleet_serving


def small_cfg(repo_root, max_iter=8):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=6, num_short_dt=6)
    cfg["apg_mpc"].update(max_iter=max_iter, max_no_improvement_iter=max_iter)
    return cfg


def fleet_problem(B, seed=0):
    """Hover states and targets up to 1 m off in x and y: NED, and ENU as
    the position config takes them."""
    rs = np.random.RandomState(seed)
    states = np.tile(hover_state().numpy(), (B, 1))
    targets = states.copy()
    targets[:, 0:2] += rs.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    return states, targets, ned2enu(torch.from_numpy(targets)).numpy()


def test_fleet_pipelined_age(repo_root):
    """Cold tick: its own plans at age 0; then the previous tick's plans at
    age > 0, picked at the row of the age."""
    fleet = FleetEngine(small_cfg(repo_root), batch=3, device="cpu")
    states, _, targets = fleet_problem(3)
    fleet.reset(states)
    u0, x0, age0 = fleet.step(states, targets)
    u1, x1, age1 = fleet.step(states, targets)
    assert age0 == 0.0 and age1 > 0.0
    assert u0.shape == (3, 4) and x0.shape == (3, 7, 13)
    # tick 1 returns the cold tick's plans again
    np.testing.assert_array_equal(x1, x0)
    assert np.isfinite(u1).all() and (u1 >= 1e-4 - 1e-6).all() and (u1 <= 1 + 1e-6).all()
    assert fleet.device_ms is None           # no device time on the CPU


def test_fleet_blocking_tick_is_the_batched_solve(repo_root):
    """``pipeline=False``: each tick returns its own plans, row 0, equal to
    the batched solve of the same inputs from the same warm start."""
    cfg = small_cfg(repo_root)
    fleet = FleetEngine(copy.deepcopy(cfg), batch=2, pipeline=False, device="cpu")
    reset_b, mpc_b, _ = make_batched_mpc(copy.deepcopy(cfg), device="cpu")
    states, _, targets = fleet_problem(2, seed=1)
    xs = torch.from_numpy(states)
    sol = mpc_b(xs, None, reset_b(xs, None, xs), torch.zeros(2), torch.from_numpy(targets))
    u, x_evol, age = fleet.step(states, targets)
    assert age == 0.0
    np.testing.assert_array_equal(u, sol.u_opt[:, 0].numpy())
    np.testing.assert_array_equal(x_evol, sol.x_evol.numpy())


def test_fleet_tracks_per_vehicle_targets(repo_root):
    """Four vehicles with their own targets close on them: after 10 blocking
    ticks (0.5 s; the position weights are gentle, halving a 1 m error
    takes ~3 s) every vehicle is nearer its target and moving towards it;
    every command is finite and inside the motor box."""
    fleet = FleetEngine(small_cfg(repo_root, max_iter=12), batch=4, pipeline=False,
                        device="cpu")
    states, targets_ned, targets = fleet_problem(4)
    err0 = np.linalg.norm(states[:, :3] - targets_ned[:, :3], axis=1)
    for _ in range(10):
        u, x_evol, _ = fleet.step(states, targets)
        assert u.shape == (4, 4) and np.isfinite(u).all()
        assert (u >= 1e-4 - 1e-6).all() and (u <= 1.0 + 1e-6).all()
        states = np.array(x_evol[:, 1, :])        # the model's own prediction
    err = np.linalg.norm(states[:, :3] - targets_ned[:, :3], axis=1)
    assert (err < err0).all(), (err0, err)
    towards = np.sum(states[:, 3:5] * (targets_ned[:, :2] - states[:, :2]), axis=1)
    assert (towards > 0).all(), towards


def test_fleet_demo_runs_on_cpu(capsys):
    """Two vehicles, five ticks, two iterations: the demo's numbers and its
    result line (a run this short does not reach the targets)."""
    res = fleet_serving.run(["--cpu", "--vehicles", "2", "--seconds", "0.25",
                             "--iters", "2"])
    out = capsys.readouterr().out
    assert "tick busy time" in out and "RESULT:" in out
    assert res["vehicles"] == 2 and res["ticks"] == 5 and res["first_age"] == 0.0
    assert res["device_ms_p50"] is None and res["device"] == "cpu"
    assert np.isfinite(res["err_mean"]) and res["ok"] == (res["err_mean"] < 0.35)


@pytest.mark.parametrize("solver, extra, steps", [
    ("mppi", ["--iters", "2"], 2), ("policy", ["--refine-iters", "2"], None)])
def test_fleet_demo_runs_mppi_and_policy(capsys, solver, extra, steps):
    """Two vehicles, five ticks of ``--solver mppi`` (``--iters`` onto
    ``mppi.iters``, 8 samples would do but the demo takes the config's 64)
    and of the policy hybrid on ``configs/models/iris_posctrl_policy.pkl``:
    the numbers and the result line."""
    res = fleet_serving.run(["--cpu", "--vehicles", "2", "--seconds", "0.25",
                             "--solver", solver] + extra)
    out = capsys.readouterr().out
    assert f"solver {solver}" in out and "RESULT:" in out
    assert res["solver"] == solver and res["ticks"] == 5 and res["first_age"] == 0.0
    assert np.isfinite(res["err_mean"]) and res["ok"] == (res["err_mean"] < 0.35)


def test_fleet_defaults_to_card(repo_root):
    cfg = small_cfg(repo_root)
    if torch.cuda.is_available():
        assert FleetEngine(cfg, batch=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FleetEngine(cfg, batch=2)

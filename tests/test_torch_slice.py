"""Port slice, end to end on the CPU: loader, controller and the iris
position-hold golden replay.

- the port's precond cache key is bit-identical to the JAX package's, so
  both load the same committed ``configs/models/precond/*.npy``;
- ``RecedingHorizonController`` replays ``replay_pos`` against the
  committed ``tests/goldens/iris_pos_flagship_trace.npz`` at the
  cross-backend gates of ``bench.py:250`` (|du| <= 0.03, |dw| <= 0.08,
  relative cost <= 0.02, pickup index exact);
- a fresh process that imports the port and runs the slice never imports
  JAX;
- configs outside the slice are refused with the ROADMAP item that brings
  them. (The trajectory replay is ``test_torch_slice_traj.py``.)
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.engine import mpc_loader as jloader
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.ops.rollout import make_time_steps as j_make_time_steps
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine import mpc_loader as tloader
from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

IRIS = ("iris_traj_mpc", "iris_posctrl_mpc")


def _controller(repo_root):
    return RecedingHorizonController(
        os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0)


@pytest.mark.parametrize("name", IRIS)
def test_precond_cache_key_matches_jax(repo_root, name):
    path = os.path.join(repo_root, f"configs/{name}.yaml")
    tcfg, jcfg = load_yaml_config(path), j_load_yaml(path)
    assert tcfg == jcfg
    ts = j_make_time_steps(20, 20, 0.05, 0.05)
    lb = np.full(4, 1e-4, np.float32)
    ub = np.ones(4, np.float32)
    k_t = tloader._precond_cache_key(tcfg, "iris", ts, lb, ub, 4, True)
    k_j = jloader._precond_cache_key(jcfg, "iris", ts, lb, ub, 4, True)
    assert k_t == k_j
    assert tloader._precond_cache_paths(tcfg, k_t) == jloader._precond_cache_paths(jcfg, k_j)


def test_flagship_traj_loads_committed_preconditioner(repo_root):
    path = os.path.join(repo_root, "configs/iris_traj_mpc.yaml")
    b = tloader.load_mpc_from_cfgfile(path)[3]
    key = jloader._precond_cache_key(
        j_load_yaml(path), "iris", j_make_time_steps(20, 20, 0.05, 0.05),
        np.full(4, 1e-4, np.float32), np.ones(4, np.float32), 4, True)
    ref = np.load(os.path.join(repo_root, "configs/models/precond", f"{key}.npy"))
    assert b.apg_config.reset_option == "bb"
    np.testing.assert_array_equal(b.precond.numpy(), ref)


@pytest.mark.parametrize("mutation, item", [
    ({"solver": "mppi"}, "MPPI"),
    ({"solver": "policy"}, "Policy solver family"),
    ({"num_particles": 8}, "Particles"),
    ({"initial_state_std": 0.01}, "Particles"),
    ({"pallas_chunk": 4}, "Particles"),
    ({"state_constr": {"state_id": [3]}}, "State constraints and slack"),
])
def test_configs_outside_the_slice_are_refused(repo_root, mutation, item):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(mutation)
    with pytest.raises(NotImplementedError, match=item):
        tloader.make_mpc_from_config(cfg)


def test_precond_cache_miss_is_refused(repo_root):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["cost_params"]["uerr"] = 2.0         # new content -> no cached artifact
    with pytest.raises(NotImplementedError, match="Preconditioner probe"):
        tloader.make_mpc_from_config(cfg)


def test_pos_replay_matches_golden(repo_root):
    c = _controller(repo_root)
    launches = AK.apg_solve_kernel.launches
    assert c.pick_command(1e6) is None          # no plan before the first solve
    tr, costs = G.replay_pos(c)
    assert AK.apg_solve_kernel.launches == launches   # CPU: plain version
    assert np.all(np.isfinite(tr))
    assert np.all(tr[:, :4] >= 1e-4 - 1e-7) and np.all(tr[:, :4] <= 1.0 + 1e-7)
    np.testing.assert_allclose(tr[:, 4:6], 0.0)       # zero-padded to 6 motors
    res = G.compare_to_golden(tr, costs, os.path.join(
        G.golden_dir(repo_root), "iris_pos_flagship_trace.npz"))
    assert res["ok"], res
    assert c.pos.solves == 6 and c.traj.solves == 0
    # a pickup 1.5 s after the last plan clamps to the horizon and counts
    n0 = c.overruns.count
    assert c.pick_command(1e6 + 5 * 50_000.0 + 1.5e6)[2] == c.pos.horizon - 1
    assert c.overruns.count == n0 + 1


def test_deadline_budget():
    """iter_budget/observe_solve: unlimited until measured, then
    deadline_ms / ms-per-iteration, floored and capped."""
    from sde4mbrl_px4_tpu_torch.engine.controller import CompiledMPC

    cm = CompiledMPC.__new__(CompiledMPC)
    cm.deadline_ms, cm.deadline_min_iters, cm.max_iter, cm._iter_ms = 30.0, 5, 200, None
    assert cm.iter_budget() == 200
    cm.observe_solve(0.050, 25)           # 2 ms/iteration
    assert cm.iter_budget() == 15
    cm.observe_solve(1.0, 10)             # 100 ms/iteration -> EWMA 31.4
    assert cm.iter_budget() == 5
    cm.observe_solve(0.0, 0)              # no iteration: ignored
    assert cm._iter_ms == pytest.approx(0.7 * 2.0 + 0.3 * 100.0)


def test_slice_runs_without_jax(repo_root):
    """A fresh process imports the port, builds the controller and solves
    once in each mode without JAX ever entering ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import sde4mbrl_px4_tpu_torch
        from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
        from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
        c = RecedingHorizonController("configs/iris_traj_mpc.yaml",
                                      "configs/iris_posctrl_mpc.yaml")
        c.traj.deadline_ms = c.pos.deadline_ms = 1.0   # short solves
        c.traj._iter_ms = c.pos._iter_ms = 1.0
        c.traj.deadline_min_iters = c.pos.deadline_min_iters = 2
        x = hover_state().numpy()
        for mode in ("pos", "traj"):
            rec = c.solve_once(x, CONTROL_STATES[mode], 0.5, x, 1e6)
            assert rec.num_steps == 2, rec
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("NO_JAX_OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=repo_root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO_JAX_OK" in r.stdout, r.stdout + r.stderr


def test_mpc_fn_contract(repo_root):
    """``mpc_fn`` returns the plan, the shifted warm start, the untouched
    generator and x_evol whose row 0 is the state; CPU tensors stay on CPU."""
    cfg, (reset_fn, mpc_fn), sft, b = tloader.load_mpc_from_cfgfile(
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    assert sft is None and cfg["_time_steps"] == pytest.approx([0.05] * 20)
    x = torch.zeros(13)
    x[6] = 1.0
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    assert st.yk.shape == (20, 4) and float(st.stepsize) == pytest.approx(0.01)
    sol = mpc_fn(x, gen, st, 0.0, x, 3)
    assert sol.rng is gen
    assert sol.u_opt.shape == (20, 4) and sol.x_evol.shape == (21, 13)
    torch.testing.assert_close(sol.x_evol[0], x)
    torch.testing.assert_close(sol.opt_state.yk[:-1], sol.u_opt[1:])
    torch.testing.assert_close(sol.opt_state.yk[-1], sol.u_opt[-1])
    assert int(sol.opt_state.num_steps) == 3

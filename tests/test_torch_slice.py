"""Port slice, end to end on the CPU: loader, controller and the iris
position-hold golden replay.

- the port's precond cache key is bit-identical to the JAX package's, so
  both load the same committed ``configs/models/precond/*.npy``;
- ``RecedingHorizonController`` replays ``replay_pos`` against the
  committed ``tests/goldens/iris_pos_flagship_trace.npz`` at the
  cross-backend gates of ``bench.py:250`` (|du| <= 0.03, |dw| <= 0.08,
  relative cost <= 0.02, pickup index exact);
- a fresh process that imports the port and runs the slice (the
  whole-solve route at P=1 and with particles, MPPI and fixed-step APG)
  never imports JAX;
- particle configs and ``state_constr`` configs (both forms, APG and MPPI)
  load and route to the kernel wrappers, and so do the four hexa configs;
  configs outside the slice are refused with the ROADMAP item that brings
  them, and the settings the
  original refuses (particle options, ``solver: policy`` with proximal
  slack) raise ValueError as there;
- every entry point runs on the card unless asked for the CPU: without
  CUDA it raises, naming the missing card. (The trajectory replay is
  ``test_torch_slice_traj.py``.)
"""
import os
import re
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
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import SC_PENALTY, SC_PROX, sc_kind

IRIS = ("iris_traj_mpc", "iris_posctrl_mpc")


def _controller(repo_root):
    return RecedingHorizonController(
        os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device="cpu")


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
    b = tloader.load_mpc_from_cfgfile(path, device="cpu")[3]
    key = jloader._precond_cache_key(
        j_load_yaml(path), "iris", j_make_time_steps(20, 20, 0.05, 0.05),
        np.full(4, 1e-4, np.float32), np.ones(4, np.float32), 4, True)
    ref = np.load(os.path.join(repo_root, "configs/models/precond", f"{key}.npy"))
    assert b.apg_config.reset_option == "bb"
    np.testing.assert_array_equal(b.precond.numpy(), ref)


def _mutated(repo_root, name, mutation):
    """A config with ``mutation`` applied; dotted keys reach into blocks."""
    cfg = load_yaml_config(os.path.join(repo_root, f"configs/{name}.yaml"))
    for key, val in mutation.items():
        blk, parts = cfg, key.split(".")
        for p in parts[:-1]:
            blk = blk[p]
        blk[parts[-1]] = val
    return cfg


# The particle options that run no TPU kernel in the original (it sends them
# to XLA, engine/mpc_loader.py:336-350, :434-443) stay refused, naming the
# ROADMAP item that brings them.
@pytest.mark.parametrize("mutation, item", [
    ({"solver": "mppi", "num_particles": 8}, "Particles"),
    ({"solver": "policy"}, "Policy solver family"),
    ({"num_particles": 8, "cost_params.risk_lambda": 1.0}, "Particles"),
    ({"num_particles": 8, "initial_state_std": 0.01}, "Particles"),
    ({"solver": "mppi", "num_particles": 512, "antithetic": True}, "Particles"),
    ({"num_particles": 512, "matmul_precision": "default"}, "Reduced matmul precision"),
])
def test_configs_outside_the_slice_are_refused(repo_root, mutation, item):
    cfg = _mutated(repo_root, "iris_posctrl_mpc", mutation)
    with pytest.raises(NotImplementedError, match=item):
        tloader.make_mpc_from_config(cfg, device="cpu")


# ... and the particle settings the original itself refuses
# (engine/mpc_loader.py:336-341, :464-470; solve_kernels.py:221-222;
# ops/rollout.py:47-49) raise ValueError, as there.
@pytest.mark.parametrize("mutation, match", [
    ({"cost_params.risk_lambda": 1.0}, "risk_lambda needs num_particles > 1"),
    ({"initial_state_std": 0.01}, "initial_state_std needs num_particles > 1"),
    ({"pallas_chunk": 4}, "must divide num_particles=1"),
    ({"num_particles": 8, "pallas_chunk": 3}, "must divide num_particles=8"),
    ({"num_particles": 7, "antithetic": True}, "even particle count"),
])
def test_particle_settings_the_original_refuses(repo_root, mutation, match):
    cfg = _mutated(repo_root, "iris_posctrl_mpc", mutation)
    with pytest.raises(ValueError, match=match):
        tloader.make_mpc_from_config(cfg, device="cpu")


@pytest.mark.parametrize("name, mutation, wrapper", [
    ("iris_traj_mpc", {"num_particles": 8}, "apg_solve_kernel"),
    ("iris_traj_mpc", {"num_particles": 8, "pallas_chunk": 4, "antithetic": True},
     "apg_solve_kernel"),
    ("iris_posctrl_mpc", {"num_particles": 8, "pallas_chunk": 4,
                          "apg_mpc.linesearch": None, "apg_mpc.stepsize": 1e-5},
     "cost_oracle"),
])
def test_particle_configs_route_to_the_kernel_wrappers(repo_root, monkeypatch, name,
                                                       mutation, wrapper):
    """``num_particles: 8`` (with ``pallas_chunk`` and ``antithetic``) loads
    and each solve hands the kernel wrapper of its route one (P, H, 13)
    block drawn from the generator, P and the chunk; on the CPU the wrapper
    runs its plain version."""
    cfg = _mutated(repo_root, name, mutation)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    calls = []
    orig = getattr(tloader, wrapper)

    def spy(*args, **kw):
        noise, P = args[7:9] if wrapper == "cost_oracle" else args[8:10]
        calls.append((tuple(noise.shape), P, kw["chunk"]))
        return orig(*args, **kw)

    monkeypatch.setattr(tloader, wrapper, spy)
    _, (reset_fn, mpc_fn), _, b = tloader.make_mpc_from_config(cfg, device="cpu")
    assert b.num_particles == 8
    x = torch.zeros(13)
    x[6] = 1.0
    gen = torch.Generator().manual_seed(0)
    state0 = gen.get_state()
    sol = mpc_fn(x, gen, reset_fn(x, gen, x), 0.0, x)
    assert sol.rng is gen and not torch.equal(gen.get_state(), state0)
    assert calls == [((8, 20, 13), 8, mutation.get("pallas_chunk", 0))]
    assert int(sol.opt_state.num_steps) == 2 and torch.isfinite(sol.u_opt).all()
    assert sol.x_evol.shape == (21, 13)


# the shipped proximal block and its penalty form (slack_proximal false)
SC_FORMS = {"prox": SC_PROX, "penalty": SC_PENALTY}


@pytest.mark.parametrize("solver", ["apg", "mppi"])
@pytest.mark.parametrize("form", sorted(SC_FORMS))
def test_constrained_configs_route_to_the_constraint_branch(repo_root, monkeypatch,
                                                            form, solver):
    """``iris_constr_posctrl_mpc.yaml`` in either form loads, and each solve
    hands its route's kernel wrapper the cost with that constraint form and
    the nZ-wide decision box and warm start (nZ = 4 + 6 slack columns in the
    proximal form); ``u_opt`` is the n_u control columns."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    cfg["state_constr"]["slack_proximal"] = form == "prox"
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    if solver == "mppi":
        cfg.update(solver="mppi", mppi={"samples": 8, "iters": 1})
    nZ = 10 if form == "prox" else 4
    wrapper = "apg_solve_kernel" if solver == "apg" else "cost_oracle"
    calls = []
    orig = getattr(tloader, wrapper)

    def spy(*args, **kw):
        calls.append(sc_kind(args[2]))
        if wrapper == "apg_solve_kernel":
            assert args[10].shape == (nZ,) and args[12].shape == (20, nZ)
        return orig(*args, **kw)

    monkeypatch.setattr(tloader, wrapper, spy)
    _, (reset_fn, mpc_fn), _, b = tloader.make_mpc_from_config(cfg, device="cpu")
    assert b.lb_z.shape == (nZ,) and b.lb.shape == (4,)
    x = torch.zeros(13)
    x[6], x[3] = 1.0, 0.6
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    assert st.yk.shape == (20, nZ)
    sol = mpc_fn(x, gen, st, 0.0, x)
    assert calls == [SC_FORMS[form]]
    assert sol.u_opt.shape == (20, 4) and sol.opt_state.yk.shape == (20, nZ)
    assert torch.isfinite(sol.u_opt).all() and sol.x_evol.shape == (21, 13)


def test_policy_on_prox_config_is_refused(repo_root):
    """``solver: policy`` with proximal slack stays refused, with the
    original's ValueError (``engine/mpc_loader.py:374-378``)."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    cfg["solver"] = "policy"
    with pytest.raises(ValueError, match="does not support slack_proximal"):
        tloader.make_mpc_from_config(cfg, device="cpu")


@pytest.mark.parametrize("name", ["hexa_posctrl_mpc", "hexa_traj_mpc",
                                  "hexa_sitl_posctrl_mpc", "hexa_sitl_traj_mpc"])
def test_hexa_configs_load(repo_root, name):
    """The four 6-motor configs load: the hexa model (n_u = 6, F = 15) on
    the shipped checkpoint, a (20, 6) warm start and one finite solve."""
    cfg, (reset_fn, mpc_fn), sft, b = tloader.load_mpc_from_cfgfile(
        os.path.join(repo_root, f"configs/{name}.yaml"), device="cpu")
    assert b.model.n_u == 6 and b.model.vehicle.name.startswith("hexa")
    assert int(b.params["net"]["w0"].shape[0]) == 15
    assert b.lb.shape == (6,) and b.cost_params.uref.shape == (6,)
    assert (sft is not None) == ("traj" in name) and b.num_particles == 1
    x = torch.zeros(13)
    x[6] = 1.0
    st = reset_fn(x, None, x)
    assert st.yk.shape == (20, 6)
    sol = mpc_fn(x, None, st, 0.0, x, 2)
    assert sol.u_opt.shape == (20, 6) and torch.isfinite(sol.u_opt).all()


@pytest.mark.parametrize("entry", ["load_mpc_from_cfgfile", "CompiledMPC",
                                   "RecedingHorizonController", "replay_solver_family"])
def test_entry_points_default_to_card(repo_root, entry):
    """With no device every entry point runs on the card; without CUDA it
    raises, naming the missing card (it never carries on on the CPU)."""
    from sde4mbrl_px4_tpu_torch.engine.controller import CompiledMPC

    pos = os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml")
    call = {"load_mpc_from_cfgfile": lambda: tloader.load_mpc_from_cfgfile(pos),
            "CompiledMPC": lambda: CompiledMPC(pos),
            "RecedingHorizonController": lambda: RecedingHorizonController(
                os.path.join(repo_root, "configs/iris_traj_mpc.yaml"), pos),
            "replay_solver_family": lambda: G.replay_solver_family(repo_root, "mppi",
                                                                    n=1)}[entry]
    if torch.cuda.is_available():
        if entry == "load_mpc_from_cfgfile":
            assert call()[3].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()


def test_precond_cache_miss_is_refused(repo_root):
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["cost_params"]["uerr"] = 2.0         # new content -> no cached artifact
    with pytest.raises(NotImplementedError, match="Preconditioner probe"):
        tloader.make_mpc_from_config(cfg, device="cpu")


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
    once in each mode, runs the particle and constrained routes, imports
    the node, the sim and the launcher and flies one solve through the
    engine node, without JAX ever entering ``sys.modules``; no module of
    the port imports JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import sde4mbrl_px4_tpu_torch
        from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
        from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
        c = RecedingHorizonController("configs/iris_traj_mpc.yaml",
                                      "configs/iris_posctrl_mpc.yaml", device="cpu")
        c.traj.deadline_ms = c.pos.deadline_ms = 1.0   # short solves
        c.traj._iter_ms = c.pos._iter_ms = 1.0
        c.traj.deadline_min_iters = c.pos.deadline_min_iters = 2
        x = hover_state().numpy()
        for mode in ("pos", "traj"):
            rec = c.solve_once(x, CONTROL_STATES[mode], 0.5, x, 1e6)
            assert rec.num_steps == 2, rec
        # the particle route: P=8 antithetic, chunks of 4
        import torch
        from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
        from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
        cfg = load_yaml_config("configs/iris_traj_mpc.yaml")
        cfg.update(num_particles=8, antithetic=True, pallas_chunk=4)
        cfg["apg_mpc"]["max_iter"] = 2
        _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
        xt = hover_state()
        gen = torch.Generator().manual_seed(0)
        sol = mpc_fn(xt, gen, reset_fn(xt, gen, xt), 0.5, xt)
        assert int(sol.opt_state.num_steps) == 2 and torch.isfinite(sol.u_opt).all()
        # the shipped constrained config, proximal and penalty forms
        for prox in (True, False):
            cfg = load_yaml_config("configs/iris_constr_posctrl_mpc.yaml")
            cfg["state_constr"]["slack_proximal"] = prox
            cfg["apg_mpc"]["max_iter"] = 2
            _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
            sol = mpc_fn(xt, None, reset_fn(xt, None, xt), 0.0, xt)
            assert int(sol.opt_state.num_steps) == 2 and sol.u_opt.shape == (20, 4)
            assert sol.opt_state.yk.shape == (20, 10 if prox else 4)
        # the node, the sim and the launcher: one pos solve through the
        # engine's doorbell, picked up by the ingress
        import time
        import sde4mbrl_px4_tpu_torch.launch
        import sde4mbrl_px4_tpu_torch.sim.closed_loop
        import sde4mbrl_px4_tpu_torch.sim.sitl
        from sde4mbrl_px4_tpu_torch.core.types import CTRL_POSE_ACTIVE
        from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode
        node = SDEControlNode("configs/iris_traj_mpc.yaml", "configs/iris_posctrl_mpc.yaml",
                              device="cpu", now_fn=lambda: 0.0)
        node.ctrl.pos.deadline_ms, node.ctrl.pos._iter_ms = 1.0, 1.0
        node.ctrl.pos.deadline_min_iters = 2
        node.start()
        assert node.initialize_mpc() and node.set_mode(CTRL_POSE_ACTIVE, target_pose=x)[0]
        out = None
        for _ in range(200):
            out = node.handle_state(x, 1e6)
            if out is not None:
                break
            time.sleep(0.05)
        node.stop()
        assert out is not None and out[2] == CONTROL_STATES["pos"], out
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("NO_JAX_OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=repo_root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO_JAX_OK" in r.stdout, r.stdout + r.stderr
    # and no module of the port names the JAX package in an import
    pkg = os.path.join(repo_root, "sde4mbrl_px4_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert not re.search(r"^\s*(from|import)\s+(jax|sde4mbrl_px4_tpu)\b",
                                     text, re.M), f


def test_oracle_routes_run_without_jax(repo_root):
    """A fresh process runs one MPPI solve and one fixed-step APG solve (a
    config without a linesearch block) through ``mpc_fn`` without JAX
    ever entering ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import torch
        from sde4mbrl_px4_tpu_torch.core.types import hover_state
        from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
        from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
        for route in ("mppi", "fixed_step"):
            cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
            if route == "mppi":
                cfg["solver"] = "mppi"
                cfg["mppi"] = {"samples": 16, "iters": 2}
            else:
                del cfg["apg_mpc"]["linesearch"]
                cfg["apg_mpc"]["max_iter"] = 2
            _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
            x = hover_state()
            gen = torch.Generator().manual_seed(0)
            sol = mpc_fn(x, gen, reset_fn(x, gen, x), 0.0, x)
            assert int(sol.opt_state.num_steps) == 2, route
            assert torch.isfinite(sol.u_opt).all() and sol.x_evol.shape == (21, 13)
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
        os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"), device="cpu")
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

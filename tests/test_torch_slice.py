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
- particle configs (with ``risk_lambda``, ``initial_state_std`` and MPPI
  over K x P paths too) and ``state_constr`` configs (both forms, APG and
  MPPI) load and route to the kernel wrappers, and so do the four hexa
  configs and the policy family (pure and ``refine_iters``);
  a ``matmul_precision: default`` config (once refused) loads and solves,
  and the settings the
  original refuses (particle options at P=1, ``solver: policy`` with
  proximal slack) raise ValueError as there;
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


# Reduced matmul precision was the last config outside the slice: a
# ``matmul_precision: default`` config at P=512 (the bf16 trunk on the card,
# ROADMAP.md §1 item 7) now loads and solves on the CPU, where DEFAULT is
# fp32 as in the original's XLA there.
@pytest.mark.parametrize("mutation, item", [
    ({"num_particles": 512, "matmul_precision": "default"}, "Reduced matmul precision"),
])
def test_configs_outside_the_slice_are_refused(repo_root, mutation, item):
    cfg = _mutated(repo_root, "iris_posctrl_mpc", mutation)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    _, bundle, pieces = tloader.build_mpc(cfg, device="cpu")
    assert not pieces.trunk_bf16 and bundle.num_particles == 512
    _, (reset_fn, mpc_fn), _, _ = tloader.make_mpc_from_config(cfg, device="cpu")
    x = torch.zeros(13)
    x[6], x[0] = 1.0, 0.3
    gen = torch.Generator().manual_seed(0)
    sol = mpc_fn(x, gen, reset_fn(x, gen, x), 0.0, x)
    assert int(sol.opt_state.num_steps) == 2 and torch.isfinite(sol.u_opt).all()
    assert torch.isfinite(sol.x_evol).all()


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
    # the particle options the original sends to XLA (engine/mpc_loader.py
    # :336-350, :434-443) run on the particle kernels' routes
    ("iris_posctrl_mpc", {"solver": "mppi", "num_particles": 8}, "cost_oracle"),
    ("iris_posctrl_mpc", {"num_particles": 8, "cost_params.risk_lambda": 1.0},
     "apg_solve_kernel"),
    ("iris_posctrl_mpc", {"num_particles": 8, "initial_state_std": 0.01}, "apg_solve_kernel"),
    ("iris_posctrl_mpc", {"solver": "mppi", "num_particles": 512, "antithetic": True},
     "cost_oracle"),
])
def test_particle_configs_route_to_the_kernel_wrappers(repo_root, monkeypatch, name,
                                                       mutation, wrapper):
    """``num_particles`` P (with ``pallas_chunk`` and ``antithetic``, with
    ``risk_lambda``, ``initial_state_std`` or ``solver: mppi``) loads and
    each solve hands the kernel wrapper of its route one (P, H, 13) block
    drawn from the generator, P and the chunk, the cost's ``risk_lambda``,
    and with a start spread the particles' (P, 13) starts; on the CPU the
    wrapper runs its plain version. The solo solve is the batched one at
    B = 1, so the wrapper is the ``_batched`` one and the block (1, P, H,
    13). (MPPI runs 2 rounds of 4 candidates here.)"""
    cfg = _mutated(repo_root, name, mutation)
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    mppi = cfg.get("solver") == "mppi"
    if mppi:
        cfg["mppi"] = {"samples": 4, "iters": 2}
    P = cfg["num_particles"]
    calls = []
    wrapper += "_batched"
    orig = getattr(tloader, wrapper)

    def spy(*args, **kw):
        noise, P = args[7:9] if wrapper == "cost_oracle_batched" else args[8:10]
        starts = kw["starts"]
        calls.append((tuple(noise.shape), P, kw["chunk"], args[2].risk_lambda,
                      None if starts is None else tuple(starts.shape)))
        return orig(*args, **kw)

    monkeypatch.setattr(tloader, wrapper, spy)
    _, (reset_fn, mpc_fn), _, b = tloader.make_mpc_from_config(cfg, device="cpu")
    assert b.num_particles == P
    x = torch.zeros(13)
    x[6] = 1.0
    gen = torch.Generator().manual_seed(0)
    state0 = gen.get_state()
    sol = mpc_fn(x, gen, reset_fn(x, gen, x), 0.0, x)
    assert sol.rng is gen and not torch.equal(gen.get_state(), state0)
    spread = "initial_state_std" in mutation
    assert calls == [((1, P, 20, 13), P, mutation.get("pallas_chunk", 0),
                      mutation.get("cost_params.risk_lambda"), (1, P, 13) if spread else None)]
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
    proximal form); ``u_opt`` is the n_u control columns. The solo solve is
    the batched one at B = 1 (the ``_batched`` wrappers)."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
    cfg["state_constr"]["slack_proximal"] = form == "prox"
    cfg["apg_mpc"].update(max_iter=2, max_no_improvement_iter=2)
    if solver == "mppi":
        cfg.update(solver="mppi", mppi={"samples": 8, "iters": 1})
    nZ = 10 if form == "prox" else 4
    wrapper = "apg_solve_kernel_batched" if solver == "apg" else "cost_oracle_batched"
    calls = []
    orig = getattr(tloader, wrapper)

    def spy(*args, **kw):
        calls.append(sc_kind(args[2]))
        if wrapper == "apg_solve_kernel_batched":
            assert args[10].shape == (nZ,) and args[12].shape == (1, 20, nZ)
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


@pytest.mark.parametrize("refine, wrapper", [(0, "cost_oracle"), (2, "apg_solve_kernel")])
def test_policy_configs_route_to_the_kernel_wrappers(repo_root, monkeypatch, refine,
                                                     wrapper):
    """``solver: policy`` on the shipped iris posctrl checkpoint loads; the
    pure policy hands the oracle the network's plan (its cost and
    ``x_evol``, no iteration), the hybrid hands the whole-solve kernel the
    plan as the cold warm start, at ``max_iter = refine_iters`` (the
    ``_batched`` wrappers at B = 1, as every solo solve)."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg["policy"] = {"params_path": os.path.join(
        repo_root, "configs/models/iris_posctrl_policy.pkl"), "refine_iters": refine}
    calls = []
    wrapper += "_batched"
    orig = getattr(tloader, wrapper)

    def spy(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(tloader, wrapper, spy)
    _, (reset_fn, mpc_fn), _, b = tloader.make_mpc_from_config(cfg, device="cpu")
    assert b.apg_config.max_iter == (refine or 100)
    x = torch.zeros(13)
    x[6], x[0] = 1.0, 0.3
    st = reset_fn(x, None, x)
    sol = mpc_fn(x, None, st, 0.0, x)
    assert len(calls) == 1
    if refine:
        u_init = calls[0][12]
        assert u_init.shape == (1, 20, 4)
        assert not torch.equal(u_init[0], st.yk)       # the network's plan
        assert calls[0][3].max_iter == 2 and int(sol.opt_state.num_steps) == 2
    else:
        assert int(sol.opt_state.num_steps) == 0
        assert torch.equal(sol.opt_state.init_cost, sol.opt_state.opt_cost)
    assert sol.u_opt.shape == (20, 4) and torch.isfinite(sol.u_opt).all()
    assert sol.x_evol.shape == (21, 13)


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


def test_precond_cache_miss_is_refused(repo_root, tmp_path, monkeypatch):
    """A cache miss is no longer refused (the probe is ported): new cost
    content misses, is probed, and its metric is written to the first
    writable cache path, here the env dir in ``tmp_path`` (never under
    ``configs/models/precond/``); tests/test_torch_precond.py holds the
    probe to the JAX package's."""
    monkeypatch.setenv("SDE4MBRL_PRECOND_CACHE", str(tmp_path))
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["cost_params"]["uerr"] = 2.0         # new content -> no cached artifact
    _, _, _, b = tloader.make_mpc_from_config(cfg, device="cpu")
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".npy")
    np.testing.assert_array_equal(np.load(tmp_path / files[0]), b.precond.numpy())
    assert b.precond.shape == (20, 4) and float(b.precond.max()) == 1.0


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
    once in each mode, runs the particle and constrained routes, a batched
    solve and a fleet tick, imports the node, the sim, the fleet demo and
    the launcher and flies one solve through the engine node, then writes
    and reads flight logs (``io/flight_log.py``, ``io/ulog.py``), takes
    two ``train_sde`` steps, evaluates and labels a state (``learning/``)
    and imports the learning drives, runs a one-period MPPI and weight
    sweep (``tuning/``), the geometric law (``baselines/``) and ``trajgen``
    and imports the mismatch, tuning, soak and baseline drives, then parses
    the router confs and a parameter dump, steps the mission layer's
    vehicle and dispatches a verb (``io/router.py``, ``io/px4_params.py``,
    ``cli/mission.py``) and imports the SITL stack, router bench, analysis
    and preflight drives, then runs the mesh layer on this process's (1, 1)
    mesh (a batched and a particle-sharded solve, the latter with risk too,
    timed by ``engine/profiling.py``'s ``SolveTimer``; the gather), builds the
    PX4 parameter dump and imports the mesh's rank programs and the
    scaling, constrained and two-process drives, without JAX ever entering
    ``sys.modules``; no module of the port, the rank workers among them,
    imports JAX or the JAX package."""
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
        # the batched route and the fleet: two scenarios, two iterations
        import sde4mbrl_px4_tpu_torch.sim.fleet_serving
        from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs, make_batched_mpc
        from sde4mbrl_px4_tpu_torch.parallel.fleet import FleetEngine
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg["apg_mpc"]["max_iter"] = 2
        reset_b, mpc_b, _ = make_batched_mpc(cfg, device="cpu")
        xs, gen = make_batch_inputs(2, spread=0.3, device="cpu")
        sol = mpc_b(xs, gen, reset_b(xs, gen, xs), torch.zeros(2), xs)
        assert sol.u_opt.shape == (2, 20, 4) and sol.opt_state.num_steps.tolist() == [2, 2]
        u_now, _, age = FleetEngine(cfg, batch=2, device="cpu").step(xs.numpy(), xs.numpy())
        assert u_now.shape == (2, 4) and age == 0.0
        # a batched MPPI call (K = 8, 2 rounds) on the batched oracle
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg.update(solver="mppi", mppi={"samples": 8, "iters": 2})
        reset_b, mpc_b, _ = make_batched_mpc(cfg, device="cpu")
        sol = mpc_b(xs, gen, reset_b(xs, gen, xs), torch.zeros(2), xs)
        assert sol.u_opt.shape == (2, 20, 4) and sol.opt_state.num_steps.tolist() == [2, 2]
        # the policy family on the shipped checkpoint: the pure policy and
        # the hybrid
        for refine in (0, 2):
            cfg = load_yaml_config("configs/iris_traj_mpc.yaml")
            cfg["solver"] = "policy"
            cfg["policy"] = {"params_path": "configs/models/iris_traj_policy.pkl",
                             "refine_iters": refine}
            _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
            sol = mpc_fn(xt, None, reset_fn(xt, None, xt), 0.5, xt)
            assert int(sol.opt_state.num_steps) == refine and torch.isfinite(sol.u_opt).all()
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
        # the learning loop: flight logs, a training step, a label, the
        # evaluation and the drives, imported and run without JAX
        import os, tempfile
        import sde4mbrl_px4_tpu_torch.sim.eval_model
        import sde4mbrl_px4_tpu_torch.sim.policy_distill
        import sde4mbrl_px4_tpu_torch.sim.train_model
        from sde4mbrl_px4_tpu_torch.io.flight_log import FlightRecorder, load_flight_log
        from sde4mbrl_px4_tpu_torch.io.ulog import read_ulog
        from sde4mbrl_px4_tpu_torch.learning import (
            DistillConfig, TrainConfig, TrajectoryDataset, kstep_errors, train_sde)
        from sde4mbrl_px4_tpu_torch.learning.distill import label_states
        from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
        from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
        rec = FlightRecorder()
        for k in range(12):
            rec.record(0.02 * k, x, cmd_motors=np.full(6, 0.7, np.float32))
        with tempfile.TemporaryDirectory() as td:
            for suffix in (".npz", ".ulg"):
                rec.save(os.path.join(td, "f" + suffix))
            assert len(load_flight_log(os.path.join(td, "f.npz"))["t"]) == 12
            assert "vehicle_local_position" in read_ulog(os.path.join(td, "f.ulg"))["data"]
        m = NeuralSDE.for_vehicle(iris_config())
        p0 = init_params(torch.Generator().manual_seed(0), m)
        t, xs_, us_ = np.arange(12) * 0.02, np.tile(x, (12, 1)), np.full((12, 4), 0.7)
        ds = TrajectoryDataset(t, xs_, us_.astype(np.float32), 3)
        _, met = train_sde(m, p0, ds, TrainConfig(window=3, batch_size=4, steps=2),
                           log_every=0, device="cpu")
        assert np.isfinite(met["final_loss"])
        assert kstep_errors(m, p0, t, xs_, us_, ks=(2,), device="cpu")["k2"]["windows"] > 0
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg["apg_mpc"]["max_iter"] = 2
        lab = label_states(cfg, xs[:1], torch.zeros(1), xs[:1], None,
                           DistillConfig(expert_max_iter=1), device="cpu")
        assert lab.shape == (1, 20, 4)
        # tuning, the baselines and their drives: a 2-candidate MPPI sweep
        # and a weight sweep of one period each, the geometric law, trajgen
        import sde4mbrl_px4_tpu_torch.sim.geometric_baseline
        import sde4mbrl_px4_tpu_torch.sim.mismatch_sweep
        import sde4mbrl_px4_tpu_torch.sim.soaks
        import sde4mbrl_px4_tpu_torch.sim.tune_mppi
        from sde4mbrl_px4_tpu_torch.baselines import GeoParams, geometric_control
        from sde4mbrl_px4_tpu_torch.models.trajgen import circle_trajectory
        from sde4mbrl_px4_tpu_torch.tuning import (
            make_mppi_grid, make_weight_grid, tune_cost_weights, tune_mppi)
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg.update(horizon=6, num_short_dt=6, mppi={"samples": 8, "iters": 2})
        res = tune_mppi(cfg, make_mppi_grid([0.01, 0.03], [0.1], [0.5]), steps=1,
                        device="cpu")
        assert len(res) == 2 and np.isfinite(res[0].mean_pos_err)
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg.update(horizon=6, num_short_dt=6)
        cfg["apg_mpc"]["max_iter"] = 2
        res = tune_cost_weights(cfg, make_weight_grid([0.5, 2.0], [1.0], [1.0], [1.0]),
                                steps=1, device="cpu")
        assert len(res) == 2 and np.isfinite(res[0].score)
        cmd, _ = geometric_control(GeoParams(), hover_state(), torch.zeros(3), torch.zeros(3),
                                   torch.zeros(3), torch.tensor(0.0))
        assert 0.0 < float(cmd[3]) <= 1.0 and circle_trajectory().shape[1] == 11
        # the deployment stack: router confs, PX4 params, the mission layer
        # over the plant, and the drives
        import sde4mbrl_px4_tpu_torch.sim.analyze
        import sde4mbrl_px4_tpu_torch.sim.bench_router
        import sde4mbrl_px4_tpu_torch.sim.full_sitl_stack
        import sde4mbrl_px4_tpu_torch.sim.preflight
        from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle, dispatch
        from sde4mbrl_px4_tpu_torch.io.px4_params import parse_params_file
        from sde4mbrl_px4_tpu_torch.io.router import Deframer, parse_conf
        from sde4mbrl_px4_tpu_torch.models.params_io import load_params
        from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant
        assert [e.name for e in parse_conf(open("configs/router_sitl.conf").read())] == [
            "fcu", "telemetry", "mpc", "liveview"]
        assert len(parse_params_file("configs/params_hexa.params")) == 9
        from sde4mbrl_px4_tpu_torch.io.mavlink import encode_full_state
        frame = bytes(encode_full_state(1, x))
        assert Deframer().feed(frame + frame) == [frame, frame]
        veh = SimVehicle(FCUSim(SDEPlant(m, load_params("configs/models/iris_sde.pkl")[0])))
        ctl = MissionControl(veh, engine=None, log=lambda *a: None)
        assert dispatch(ctl, "takeoff z=1.0")
        for _ in range(2):
            ctl.tick()
            veh.step(0.02)
        assert veh.armed and np.isfinite(veh.position()).all()
        # the mesh layer on this process's (1, 1) mesh, the example drives
        # and the parameter generator
        import sde4mbrl_px4_tpu_torch.parallel.rank_tasks
        import sde4mbrl_px4_tpu_torch.sim.bench_scaling
        import sde4mbrl_px4_tpu_torch.sim.closed_loop_two_process
        from sde4mbrl_px4_tpu_torch.parallel.batched import make_particle_sharded_mpc
        from sde4mbrl_px4_tpu_torch.parallel.distributed import (
            gather_to_host, global_batch_inputs, initialize_distributed)
        from sde4mbrl_px4_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
        from sde4mbrl_px4_tpu_torch.sim import constrained_mpc, gen_px4_params
        assert initialize_distributed() is False and best_mesh_shape(8, 4, 8) == (4, 2)
        mesh = make_mesh(devices="cpu")
        cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
        cfg.update(horizon=6, num_short_dt=6)
        cfg["apg_mpc"]["max_iter"] = 2
        reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)
        xs_m, gen_m, ts_m = global_batch_inputs(mesh, 2, spread=0.3)
        sol = mpc_b(xs_m, gen_m, reset_b(xs_m, gen_m, xs_m), ts_m, xs_m)
        assert gather_to_host(sol.u_opt, mesh).shape == (2, 6, 4)
        cfg.update(num_particles=4)
        reset_fn, mpc_fn, _ = make_particle_sharded_mpc(cfg, mesh)
        gen = torch.Generator().manual_seed(0)
        sol = mpc_fn(xt, gen, reset_fn(xt, gen, xt), 0.0, xt)
        assert int(sol.opt_state.num_steps) == 2 and sol.x_evol.shape == (7, 13)
        from sde4mbrl_px4_tpu_torch.engine.profiling import SolveTimer, trace
        cfg["cost_params"]["risk_lambda"] = 2.0
        reset_fn, mpc_fn, _ = make_particle_sharded_mpc(cfg, mesh)
        timer = SolveTimer()
        with timer:
            sol = mpc_fn(xt, gen, reset_fn(xt, gen, xt), 0.0, xt)
        assert np.isfinite(sol.u_opt.numpy()).all() and timer.stats()["n"] == 1
        assert len(gen_px4_params.build_params()) > 1000
        assert callable(constrained_mpc.fly)
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
    config without a linesearch block) through ``mpc_fn``, then a risk
    solve with a start spread (P=8) and an MPPI solve over K x P paths,
    without JAX ever entering ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        import torch
        from sde4mbrl_px4_tpu_torch.core.types import hover_state
        from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
        from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
        for route in ("mppi", "fixed_step", "risk_starts", "mppi_particles"):
            cfg = load_yaml_config("configs/iris_posctrl_mpc.yaml")
            if route.startswith("mppi"):
                cfg["solver"] = "mppi"
                cfg["mppi"] = {"samples": 16, "iters": 2}
            elif route == "fixed_step":
                del cfg["apg_mpc"]["linesearch"]
                cfg["apg_mpc"]["max_iter"] = 2
            else:
                cfg["apg_mpc"]["max_iter"] = 2
                cfg["cost_params"]["risk_lambda"] = 2.0
                cfg["initial_state_std"] = 0.05
            if route in ("risk_starts", "mppi_particles"):
                cfg.update(num_particles=8, antithetic=True)
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

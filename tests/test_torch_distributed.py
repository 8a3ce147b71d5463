"""Port, rank pairs on the CPU (L6): the mesh layer over ``torch.distributed``
(gloo), two fresh processes a pair on a ``file://`` store
(``parallel/distributed.py::spawn_ranks``, the rank programs of
``parallel/rank_tasks.py``), held as the JAX package holds its mesh
(``tests/test_distributed.py``, ``tests/test_sharding.py``), on its tiny
config (H = 5, ``max_iter`` 5; the particle pair on
``tests/test_sharding.py``'s H = 6, ``max_iter`` 12, P = 8):

- dp: a (2, 1) mesh's batched solve of B = 8 (cold, then warm) equals the
  one-process ``make_batched_mpc`` bit for bit, and JAX's ``make_batched_mpc``
  on a (2, 1) mesh of the virtual CPU devices at rtol 2e-4 / atol 2e-5
  (``tests/test_sharding.py:76-77``);
- fleet: four ticks of an 8-vehicle ``FleetEngine`` over two ranks equal
  the one-process fleet at rtol 1e-5 / atol 1e-6 (``tests/
  test_distributed.py:148``);
- mc: the particle-sharded solve over (1, 2) equals the one-process host
  loop on the same draws at rtol 2e-4 / atol 2e-5, the loop equals the
  solo ``mpc_fn``, and on JAX's own draws (``tests/_torch_parity.py``) it
  matches JAX's ``make_particle_sharded_mpc`` on a (4, 2) mesh;
- ``distill_policy(mesh=)`` on this process's mesh equals it without one;
- ``sim/tune_mppi.py --mesh-dp 2 --cpu`` spawns its two ranks and scores
  an odd grid row for row as one process does;
- ``launch.py --coordinator``: two engine nodes (``--cpu``) form a world
  of two, serve, and stop cleanly on SIGTERM.

``train_sde``, ``label_states`` and the tuners over rank pairs are in
``test_torch_learning.py``, ``test_torch_distill.py`` and
``test_torch_tuning.py``. Every pair has its own time limit, which kills
its ranks.
"""
import copy
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import jax_solve_draws
from sde4mbrl_px4_tpu.core.types import hover_state as j_hover
from sde4mbrl_px4_tpu.parallel import batched as jbatched
from sde4mbrl_px4_tpu.parallel.mesh import make_mesh as j_make_mesh
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.parallel import rank_tasks as RT
from sde4mbrl_px4_tpu_torch.parallel.distributed import spawn_ranks
from sde4mbrl_px4_tpu_torch.parallel.mesh import make_mesh

RTOL, ATOL = 2e-4, 2e-5            # tests/test_sharding.py:76-77, :103-104
FLEET_RTOL, FLEET_ATOL = 1e-5, 1e-6  # tests/test_distributed.py:148
TASKS = "sde4mbrl_px4_tpu_torch.parallel.rank_tasks"
PAIR_S = 90.0                      # each pair's time limit


def tiny_cfg(repo_root, **top):
    """``tests/test_distributed.py:24-31``: H = 5, ``max_iter`` 5."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=5, num_short_dt=5, **top)
    cfg["apg_mpc"].update(max_iter=5, max_no_improvement_iter=5)
    return cfg


def pair(task: str, **kw) -> list:
    return spawn_ranks(f"{TASKS}:{task}", 2, dict(devices="cpu", **kw), timeout=PAIR_S)


def test_dp_pair_equals_one_process_and_jax(repo_root):
    cfg = tiny_cfg(repo_root)
    ranks = pair("dp_solve", cfg=copy.deepcopy(cfg), B=8)
    one = RT.dp_solve(copy.deepcopy(cfg), 8, devices="cpu")
    assert [r["rows"] for r in ranks] == [4, 4] and one["rows"] == 8
    for step in range(2):
        for r in ranks:
            np.testing.assert_array_equal(r["u"][step], one["u"][step])
            np.testing.assert_array_equal(r["num_steps"][step], one["num_steps"][step])
    assert (ranks[0]["num_steps"][0] > 0).all()

    jmesh = j_make_mesh((2, 1), devices=jax.devices()[:2])
    reset_b, mpc_b, _ = jbatched.make_batched_mpc(copy.deepcopy(cfg), jmesh)
    xs, rngs = jbatched.make_batch_inputs(jmesh, 8, seed=0, spread=0.5)
    ts = jnp.zeros((8,), jnp.float32)
    sol = mpc_b(xs, rngs, reset_b(xs, rngs, xs), ts, xs)
    u1 = np.asarray(sol.u_opt)
    sol = mpc_b(xs, sol.rng, sol.opt_state, ts, xs)
    for step, u_j in enumerate((u1, np.asarray(sol.u_opt))):
        np.testing.assert_allclose(ranks[0]["u"][step], u_j, rtol=RTOL, atol=ATOL)


def test_fleet_pair_equals_one_process(repo_root):
    cfg = tiny_cfg(repo_root)
    ranks = pair("fleet", cfg=copy.deepcopy(cfg), B=8)
    one = RT.fleet(copy.deepcopy(cfg), 8, devices="cpu")
    assert [r["rows"] for r in ranks] == [4, 4]
    for r in ranks:
        np.testing.assert_allclose(r["states"], one["states"], rtol=FLEET_RTOL,
                                   atol=FLEET_ATOL)
    start, _ = RT.fleet_inputs(8)
    assert np.abs(one["states"] - start).max() > 1e-3            # they flew


def particle_cfg(repo_root):
    """``tests/test_sharding.py:21-31`` at P = 4 * mc = 8."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=6, num_short_dt=6, num_particles=8)
    cfg["apg_mpc"].update(max_iter=12, max_no_improvement_iter=12)
    return cfg


def test_particle_sharded_pair(repo_root):
    """mc = 2 on JAX's own draws (``tests/_torch_parity.py``), two chained
    solves: against one process on the same draws, the one-process loop
    against the solo ``mpc_fn`` (the whole solve's plain version), and the
    first solve against JAX's particle-sharded solve on a (4, 2) mesh."""
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    cfg = particle_cfg(repo_root)
    draws = [d.numpy() for d in jax_solve_draws(8, 2, False, H=6)]
    ranks = pair("particle_solve", cfg=copy.deepcopy(cfg), solves=2, draws=draws)
    one = RT.particle_solve(copy.deepcopy(cfg), solves=2, shape=(1, 1), devices="cpu",
                            draws=draws)
    np.testing.assert_array_equal(ranks[0]["u"], ranks[1]["u"])     # one step on every rank
    np.testing.assert_array_equal(ranks[0]["x_evol"], ranks[1]["x_evol"])
    for a, b in zip(ranks[0]["plans"], one["plans"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["x_evol"], one["x_evol"], rtol=RTOL, atol=ATOL)
    assert ranks[0]["opt_cost"] == pytest.approx(one["opt_cost"], rel=RTOL)
    assert ranks[0]["iterations"] == one["iterations"]
    assert ranks[0]["collective_calls"] > 0 and one["collective_calls"] == 0

    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    x0 = hover_state()
    x0[0] = 0.4
    blocks = iter(torch.from_numpy(d) for d in draws)
    st = reset_fn(x0, None, x0)
    for plan in one["plans"]:
        sol = mpc_fn(x0, blocks, st, 0.0, x0)
        st = sol.opt_state
        np.testing.assert_allclose(sol.u_opt.numpy(), plan, rtol=RTOL, atol=ATOL)

    jmesh = j_make_mesh((4, 2), devices=jax.devices()[:8])
    j_reset, j_mpc, _ = jbatched.make_particle_sharded_mpc(copy.deepcopy(cfg), jmesh)
    xj = j_hover().at[0].set(0.4)
    key = jax.random.PRNGKey(0)
    sol_j = j_mpc(xj, key, j_reset(xj, key, xj), jnp.float32(0.0), xj)
    np.testing.assert_allclose(ranks[0]["plans"][0], np.asarray(sol_j.u_opt), rtol=RTOL,
                               atol=ATOL)


def test_distill_policy_on_a_mesh(repo_root):
    """``distill_policy(mesh=)`` on this process's (1, 1) mesh: the labels
    take the mesh route and the policy equals the one without a mesh."""
    from sde4mbrl_px4_tpu_torch.learning.distill import DistillConfig, distill_policy

    cfg = tiny_cfg(repo_root)
    dcfg = DistillConfig(n_states=3, expert_max_iter=3, hidden=(16, 16), batch_size=3,
                         steps=11)
    pol_m, st_m = distill_policy(copy.deepcopy(cfg), dcfg, mesh=make_mesh(devices="cpu"),
                                 device="cpu")
    pol, st = distill_policy(copy.deepcopy(cfg), dcfg, device="cpu")
    assert st_m["losses"] == st["losses"]
    for i in range(pol.n_layers):
        assert torch.equal(getattr(pol_m, f"w{i}"), getattr(pol, f"w{i}"))


def test_tune_mppi_drive_spawns_its_mesh(repo_root, tmp_path):
    from sde4mbrl_px4_tpu_torch.sim import tune_mppi as drive
    from sde4mbrl_px4_tpu_torch.tuning import make_mppi_grid, tune_mppi

    cfg = tiny_cfg(repo_root, solver="mppi")
    cfg["mppi"] = {"samples": 8, "iters": 2}
    path = tmp_path / "mppi.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--sigmas", "0.01,0.04", "--temps", "0.1", "--betas", "0.0,0.5,0.7", "--steps", "2"]
    out = drive.run([str(path), *args, "--mesh-dp", "2", "--cpu"])
    grid = make_mppi_grid([0.01, 0.04], [0.1], [0.0, 0.5, 0.7])
    one = tune_mppi(load_yaml_config(str(path)), grid, steps=2, device="cpu")
    assert len(out["results"]) == 6
    assert [tuple(r) for r in out["results"]] == [tuple(r) for r in one]


def test_launcher_coordinator_pair_and_sigterm(repo_root, tmp_path):
    """Two ``launch.py --coordinator file://... --num-processes 2
    --process-id r --cpu`` engine nodes (tiny configs, own ports): each
    prints its rank and READY, and exits 0 with its stop line on SIGTERM."""
    import socket

    def free_port():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    paths = []
    for traj in (True, False):
        cfg = tiny_cfg(repo_root)
        cfg["learned_model_params"] = os.path.join(repo_root, "configs/models/iris_sde.pkl")
        if traj:
            cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
        p = tmp_path / f"{'traj' if traj else 'pos'}.yaml"
        p.write_text(yaml.safe_dump(cfg))
        paths.append(str(p))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    for r in range(2):
        lf = tmp_path / f"engine{r}.yaml"
        lf.write_text(yaml.safe_dump({
            "node": "sde_control", "config_dir": "/", "traj_ctrl": paths[0],
            "sp_ctrl": paths[1], "addr_mavlink_state_msg": f"127.0.0.1:{free_port()}",
            "addr_services": f"127.0.0.1:{free_port()}"}))
        p = subprocess.Popen(
            [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", str(lf), "--cpu",
             "--coordinator", f"file://{tmp_path}/store", "--num-processes", "2",
             "--process-id", str(r)],
            cwd=repo_root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = []
        threading.Thread(target=lambda p=p, lines=lines: lines.extend(p.stdout),
                         daemon=True).start()
        procs.append(p)
        logs.append(lines)
    try:
        t0 = time.monotonic()
        while not all(any("[launch] READY" in ln for ln in lg) for lg in logs):
            assert time.monotonic() - t0 < PAIR_S and all(p.poll() is None for p in procs), logs
            time.sleep(0.1)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    time.sleep(0.2)
    for r, (p, lg) in enumerate(zip(procs, logs)):
        out = "".join(lg)
        assert p.returncode == 0, out
        assert f"[launch] rank {r} of 2 (gloo); the node runs on cpu" in out, out
        assert "[launch] engine stopped" in out and "Traceback" not in out, out

"""Port, the mesh layer on the CPU (L6): ``parallel/mesh.py``,
``parallel/distributed.py`` and the loader's mesh hooks, against the JAX
package's ``parallel/mesh.py`` and its invariants
(``tests/test_sharding.py``).

- ``best_mesh_shape`` returns the JAX function's answers over a grid of
  (devices, scenarios, particles);
- a mesh without a process group is (1, 1) over this process; a shape
  that does not multiply to the world raises, as the original does; a
  rank asked for the card without CUDA raises; the scenario sharding's
  spec and rows;
- ``initialize_distributed`` returns False when nothing asks for a group,
  raises on a half-given world, and raises (never carries on alone) when a
  world of two cannot form;
- a scenario's draws do not depend on the mesh (``build_mpc``'s
  ``shard``): the rows of a batch solved as the second half of a (2, 1)
  mesh equal those rows of the whole batch, bit for bit, for particle
  blocks with start spreads and for MPPI noise;
- risk under a sharded particle axis builds (its solve is in
  ``tests/test_torch_distributed.py``); particles that do not split into
  blocks of two or more are refused;
- ``sim/bench_scaling.py`` runs its dist and solo sweep over 1 and 2 CPU
  ranks and writes its result where it is told (never ``SCALING.json``).

The rank pairs against one process and JAX are in
``tests/test_torch_distributed.py``.
"""
import copy
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from sde4mbrl_px4_tpu.parallel.mesh import best_mesh_shape as j_best_mesh_shape
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import ParticleShard, build_mpc
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs
from sde4mbrl_px4_tpu_torch.parallel.distributed import initialize_distributed
from sde4mbrl_px4_tpu_torch.parallel.mesh import (
    best_mesh_shape, make_mesh, replicated, scenario_sharding)


def tiny_cfg(repo_root, **top):
    """The JAX package's two-process config (``tests/test_distributed.py:
    24-31``): H = 5, ``max_iter`` 5."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=5, num_short_dt=5, **top)
    cfg["apg_mpc"].update(max_iter=5, max_no_improvement_iter=5)
    return cfg


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 16])
def test_best_mesh_shape_matches_jax(n_devices):
    for n_scen in (0, 1, 2, 3, 4, 5, 8, 12, 64, 100):
        for n_part in (1, 2, 3, 4, 6, 8, 512, 1000):
            got = best_mesh_shape(n_devices, n_scen, n_part)
            assert got == j_best_mesh_shape(n_devices, n_scen, n_part)
            assert got[0] * got[1] == n_devices


def test_mesh_without_a_group_is_this_process():
    mesh = make_mesh(devices="cpu")
    assert mesh.shape == {"dp": 1, "mc": 1} and mesh.axis_names == ("dp", "mc")
    assert (mesh.rank, mesh.size, mesh.dp_index, mesh.mc_index) == (0, 1, 0, 0)
    assert mesh.device == torch.device("cpu") and mesh.rows(5) == slice(0, 5)
    assert mesh.group("dp") is None and mesh.group("mc") is None
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) != 1 devices"):
        make_mesh((2, 1), devices="cpu")
    with pytest.raises(ValueError, match="2 devices for a world of 1"):
        make_mesh(devices=["cpu", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_a_rank_asked_for_the_card_without_cuda_raises():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()


def test_scenario_sharding_layout():
    mesh = make_mesh(devices="cpu")
    sh = scenario_sharding(mesh, rank=3)
    assert sh.spec == ("dp", None, None) and replicated(mesh).spec == ()
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(sh.local(x), x) and torch.equal(replicated(mesh).local(x), x)


def test_initialize_distributed_needs_a_request(monkeypatch):
    for k in ("SDE4MBRL_COORDINATOR", "SDE4MBRL_NUM_PROCESSES", "SDE4MBRL_PROCESS_ID",
              "SDE4MBRL_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    with pytest.raises(ValueError, match="coordinator address"):
        initialize_distributed("127.0.0.1:1", None, None)
    monkeypatch.setenv("SDE4MBRL_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        initialize_distributed()


def test_a_world_that_cannot_form_raises(tmp_path):
    """Rank 0 of a world of two, alone: the rendezvous times out and
    raises; it does not carry on as one process."""
    code = textwrap.dedent(f"""
        from sde4mbrl_px4_tpu_torch.parallel.distributed import initialize_distributed, world
        try:
            initialize_distributed("file://{tmp_path}/store", 2, 0, timeout_s=2.0)
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("FORMED", world())
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert "RAISED" in r.stdout and "FORMED" not in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize("kind", ["particles", "mppi"])
def test_a_scenarios_draws_do_not_depend_on_the_mesh(repo_root, kind):
    """Rows 2-3 of a batch of 4 solved as block 1 of a (2, 1) mesh equal
    rows 2-3 of the whole batch's solve, bit for bit: the block draws the
    whole batch's noise from the same generator and keeps its rows
    (particles: P=4 antithetic with a start spread; MPPI: its noise)."""
    if kind == "particles":
        cfg = tiny_cfg(repo_root, num_particles=4, antithetic=True, initial_state_std=0.05)
    else:
        cfg = tiny_cfg(repo_root, solver="mppi")
        cfg["mppi"] = {"samples": 8, "iters": 2}
    xs, _ = make_batch_inputs(4, spread=0.3, device="cpu")
    outs = []
    for shard, rows in (((0, 1), slice(0, 4)), ((1, 2), slice(2, 4))):
        _, _, pieces = build_mpc(copy.deepcopy(cfg), device="cpu", shard=shard)
        x = xs[rows]
        gen = torch.Generator().manual_seed(5)
        sol = pieces.solve(x, gen, pieces.reset(x, gen, x), torch.zeros(x.shape[0]), x)
        outs.append(sol.u_opt)
    assert torch.equal(outs[0][2:], outs[1])


def test_risk_under_a_sharded_particle_axis_is_refused(repo_root):
    """What the particle shard still refuses: particles that do not divide
    over the mc axis, or leave a block of one. Risk is no longer refused:
    ``build_mpc`` builds the shard with ``risk_lambda``, and its bundle
    keeps the cost's lambda."""
    cfg = tiny_cfg(repo_root, num_particles=4)
    cfg["cost_params"]["risk_lambda"] = 1.0
    shard = ParticleShard(index=0, count=2, reduce=lambda t: t, broadcast=lambda t, s: t)
    _, bundle, pieces = build_mpc(copy.deepcopy(cfg), device="cpu", particle_shard=shard)
    assert bundle.cost_params.risk_lambda == pytest.approx(1.0)
    assert bundle.num_particles == 4 and callable(pieces.solve)
    with pytest.raises(ValueError, match="must divide over the mc axis"):
        build_mpc(tiny_cfg(repo_root, num_particles=5), device="cpu", particle_shard=shard)
    with pytest.raises(ValueError, match="a block needs 2 or more"):
        build_mpc(tiny_cfg(repo_root, num_particles=2), device="cpu", particle_shard=shard)


def test_bench_scaling_sweeps_cpu_ranks(repo_root, tmp_path):
    """``sim/bench_scaling.py --process-sweep 1,2 --cpu`` at 2 scenarios a
    rank: a dist and a solo row per count with their rates, written to
    ``--out``; the committed ``SCALING.json`` is refused as a target."""
    from sde4mbrl_px4_tpu_torch.sim import bench_scaling

    out = tmp_path / "scaling.json"
    assert bench_scaling.main(["--process-sweep", "1,2", "--cpu", "--b-per-dev", "2",
                               "--iters", "2", "--steps", "1", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert [r["processes"] for r in res["sweep"]] == [1, 2]
    for r in res["sweep"]:
        assert r["solves_per_sec"] > 0 and r["solo_solves_per_sec"] > 0
        assert r["steps_per_solve"] == [2.0] * r["processes"]
    assert res["device"] == "cpu"
    with pytest.raises(ValueError, match="SCALING.json"):
        bench_scaling.process_sweep([1], 2, 2, 1, True,
                                    out=os.path.join(repo_root, "SCALING.json"))

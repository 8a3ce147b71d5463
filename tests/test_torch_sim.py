"""Port, the simulated vehicle on the CPU: the host modules against the JAX
package's, the plant, the FCU shim, the SITL node and one short closed
loop.

- ``DisturbanceEstimator`` and ``RigidBodyPlant`` equal to the JAX
  package's on the same input sequence (exact: both are numpy);
- the ``SDEPlant`` twin against JAX's ``SDEPlant`` over 50 steps without
  noise, the weights carried across from the same checkpoint, rtol 1e-5;
  with process noise, its draws come from its own seeded generator;
- ``FCUSim``'s watchdog, test-mode ignore and ``weight_motors`` blend
  (``tests/test_runtime.py``);
- ``FCUSimNode`` streaming and engaging over UDP (``tests/test_sitl.py``);
- ``sim/closed_loop.py --cpu`` on the tiny config for 2 s of sim time at
  time-scale 3, reaching ``MPC_ON``, with ``--solver apg`` and with
  ``--solver policy --refine-iters 2`` (checkpoints of the tiny horizon
  from ``--policy-dir``); the 0.35 m gate is held on the card.
"""
import os
import time

import numpy as np
import pytest
import torch
import yaml

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES
from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP
from sde4mbrl_px4_tpu_torch.models.params_io import load_params
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.models.vehicles import vehicle_from_name
from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant


def _plant(repo_root, vehicle="iris", **kw):
    params, _ = load_params(os.path.join(repo_root, f"configs/models/{vehicle}_sde.pkl"))
    return SDEPlant(NeuralSDE.for_vehicle(vehicle_from_name(vehicle)), params, **kw)


def test_disturbance_estimator_equals_jax():
    from sde4mbrl_px4_tpu.engine.offset import DisturbanceEstimator as J
    from sde4mbrl_px4_tpu_torch.engine.offset import DisturbanceEstimator as T

    rs = np.random.RandomState(0)
    kw = dict(gain=0.5, limit=0.3, dt=0.05, capture=1.5, leak=0.1)
    a, b = T(**kw), J(**kw)
    for k in range(200):
        x = rs.randn(13).astype(np.float32) * (0.2 if k < 150 else 2.0)
        tgt = rs.randn(13).astype(np.float32) * 0.2
        dt = None if k % 7 == 0 else float(rs.uniform(-0.1, 0.8))
        np.testing.assert_array_equal(a.update(x, tgt, dt), b.update(x, tgt, dt))
        np.testing.assert_array_equal(a.offset_ned, b.offset_ned)
        if k == 100:
            a.reset()
            b.reset()
    assert np.abs(a.offset_ned).max() > 0


@pytest.mark.parametrize("vehicle", ["iris", "hexa"])
def test_rigid_body_plant_equals_jax(vehicle):
    from sde4mbrl_px4_tpu.sim.rigid_body import RigidBodyParams as JP
    from sde4mbrl_px4_tpu.sim.rigid_body import RigidBodyPlant as JB
    from sde4mbrl_px4_tpu_torch.sim.rigid_body import RigidBodyParams as TP
    from sde4mbrl_px4_tpu_torch.sim.rigid_body import RigidBodyPlant as TB

    kw = dict(mass_scale=1.2, drag_scale=0.8, motor_tau=0.03, wind=[1.0, 0.6, 0.0])
    a = TB(TP.nominal(vehicle).perturbed(**kw), sim_dt=0.002)
    b = JB(JP.nominal(vehicle).perturbed(**kw), sim_dt=0.002)
    np.testing.assert_array_equal(a.mixing, b.mixing)
    rs = np.random.RandomState(1)
    for _ in range(40):
        u = np.clip(a.hover_u + 0.05 * rs.randn(a.n_u), 0.0, 1.0)
        np.testing.assert_array_equal(a.step(u, 0.02), b.step(u, 0.02))
        np.testing.assert_array_equal(a.u_act, b.u_act)
    assert a.t == b.t


@pytest.mark.parametrize("vehicle", ["iris", "hexa"])
def test_sde_plant_matches_jax(repo_root, vehicle):
    """50 steps without noise from the same start, under the same controls,
    the weights carried across from the checkpoint (params_from_numpy)."""
    import jax

    from sde4mbrl_px4_tpu.models.params_io import load_params as j_load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE as JN
    from sde4mbrl_px4_tpu.models.vehicles import vehicle_from_name as j_vehicle
    from sde4mbrl_px4_tpu.sim.plant import SDEPlant as JPlant

    params, _ = j_load_params(os.path.join(repo_root, f"configs/models/{vehicle}_sde.pkl"))
    jp = JPlant(JN(vehicle=j_vehicle(vehicle)), params, sim_dt=0.005)
    tp = _plant(repo_root, vehicle, sim_dt=0.005)
    assert tp.device.type == "cpu" and tp.params["net"]["w0"].device.type == "cpu"
    x0 = np.asarray(jp.x, np.float32).copy()
    x0[:3] = [0.1, -0.2, -1.0]
    jp.reset(x0)
    tp.reset(x0)
    rs = np.random.RandomState(0)
    hover = vehicle_from_name(vehicle).hover_u
    for _ in range(50):
        u = (hover + 0.05 * rs.randn(tp.model.n_u)).astype(np.float32)
        np.testing.assert_allclose(tp.step(u, 0.01), jp.step(u, 0.01), rtol=1e-5, atol=1e-6)
    assert tp.t == pytest.approx(jp.t)
    assert not np.allclose(tp.x[:3], x0[:3])
    del jax


def test_sde_plant_process_noise_is_seeded(repo_root):
    u = np.full(4, vehicle_from_name("iris").hover_u, np.float32)
    runs = []
    for seed in (3, 3, 4):
        p = _plant(repo_root, process_noise=True, seed=seed)
        runs.append(p.step(u, 0.1).copy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0], runs[2])
    quiet = _plant(repo_root)
    assert not np.allclose(quiet.step(u, 0.1), runs[0])


def test_fcu_watchdog_staleness(repo_root):
    plant = _plant(repo_root)
    fcu = FCUSim(plant)
    fcu.push_cmd(np.full(6, 0.9, np.float32), np.zeros(4, np.float32),
                 CONTROL_STATES["traj"], 100)
    u = fcu._effective_u()
    assert fcu.status == FCUSim.MPC_ON
    np.testing.assert_allclose(u, 0.9, atol=1e-6)
    plant.step(u, 0.05)                            # age the command past 20 ms
    u2 = fcu._effective_u()
    assert fcu.status == FCUSim.MPC_TIMEOUT
    np.testing.assert_allclose(u2, plant.model.vehicle.hover_u)


def test_fcu_test_mode_ignored(repo_root):
    plant = _plant(repo_root)
    fcu = FCUSim(plant)
    fcu.push_cmd(np.full(6, 0.95, np.float32), np.zeros(4, np.float32),
                 CONTROL_STATES["test"], 100)
    u = fcu._effective_u()
    assert fcu.status == FCUSim.MPC_OFF           # commands transmitted but unused
    np.testing.assert_allclose(u, plant.model.vehicle.hover_u)


@pytest.mark.parametrize("vehicle", ["iris", "hexa"])
def test_fcu_weight_motors_blend(repo_root, vehicle):
    plant = _plant(repo_root, vehicle)
    fcu = FCUSim(plant)
    motors = np.full(6, 0.9, np.float32)
    tr = np.array([0.7, 0, 0, 0], np.float32)
    outs = {}
    for w in (100, 0, 50):
        fcu.push_cmd(motors, tr, CONTROL_STATES["traj"], w)
        outs[w] = fcu._effective_u()
    assert outs[100].shape == (plant.model.n_u,)
    np.testing.assert_allclose(outs[100], 0.9, atol=1e-6)
    np.testing.assert_allclose(outs[50], 0.5 * outs[100] + 0.5 * outs[0], atol=1e-6)
    assert not np.allclose(outs[0], outs[100])


def test_plant_hover_stability(repo_root):
    plant = _plant(repo_root)
    plant.step(np.full(4, plant.model.vehicle.hover_u, np.float32), 1.0)
    assert abs(float(plant.x[2])) < 0.05            # holds altitude within 5 cm over 1 s


def test_fcu_sim_node_config_surface(repo_root):
    """Both shipped SITL launch files build a node on the port's plant."""
    from sde4mbrl_px4_tpu_torch.launch import _load
    from sde4mbrl_px4_tpu_torch.sim.sitl import fcu_sim_from_config

    for name, n_u in (("iris_px4_sitl.yaml", 4), ("hexa_px4_sitl.yaml", 6)):
        cfg = _load(os.path.join(repo_root, "configs", "launch", name))
        assert cfg["node"] == "fcu_sim"
        cfg["addr_mavlink_state_msg"] = "127.0.0.1:9"      # not started
        node = fcu_sim_from_config(cfg)
        assert node.fcu.n_u == n_u and isinstance(node.fcu.plant, SDEPlant)
        assert node.fcu.plant.device.type == "cpu"
        node.link.close()


def test_fcu_sim_node_streams_and_engages(repo_root):
    """Over the wire: valid 13-state frames at the configured rate; an
    engaged command stream flips the FCU to MPC_ON; a CTRL_TEST command
    leaves it disengaged; silence trips the 20 ms watchdog."""
    from sde4mbrl_px4_tpu_torch.launch import _load
    from sde4mbrl_px4_tpu_torch.sim.sitl import fcu_sim_from_config

    eng = MavlinkUDP("127.0.0.1:0", mode="udpin")
    port = eng.sock.getsockname()[1]
    cfg = _load(os.path.join(repo_root, "configs", "launch", "iris_px4_sitl.yaml"))
    cfg["addr_mavlink_state_msg"] = f"127.0.0.1:{port}"
    cfg["initial_position_ned"] = [0.5, 0.0, -1.0]
    node = fcu_sim_from_config(cfg)
    node.start()
    try:
        msg = eng.recv_match(type="MPC_FULL_STATE", timeout=2.0)
        assert msg is not None, "no MPC_FULL_STATE within 2 s"
        x = np.asarray(msg.state)
        np.testing.assert_allclose(np.linalg.norm(x[6:10]), 1.0, atol=1e-3)
        np.testing.assert_allclose(x[:3], [0.5, 0.0, -1.0], atol=0.2)
        hov = float(node.fcu.hover_u)
        motors = np.full(6, hov, np.float32)
        tr = np.array([hov, 0, 0, 0], np.float32)
        eng.send_motors_cmd(int(time.time() * 1e6), motors, tr, CONTROL_STATES["test"], 100)
        time.sleep(0.05)
        assert node.fcu.status != node.fcu.MPC_ON
        deadline = time.time() + 3.0
        while time.time() < deadline and node.fcu.status != node.fcu.MPC_ON:
            eng.send_motors_cmd(int(time.time() * 1e6), motors, tr, CONTROL_STATES["pos"], 100)
            time.sleep(0.005)
        assert node.fcu.status == node.fcu.MPC_ON
        time.sleep(0.15)
        assert node.fcu.status == node.fcu.MPC_TIMEOUT
        assert node.ticks > 0
    finally:
        node.stop()
        eng.close()


def _tiny(repo_root, tmp_path):
    paths = []
    for with_traj in (True, False):
        cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
        cfg.update(horizon=5, num_short_dt=5,
                   learned_model_params=os.path.join(repo_root, "configs/models/iris_sde.pkl"))
        cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
        if with_traj:
            cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
        p = tmp_path / ("traj.yaml" if with_traj else "pos.yaml")
        p.write_text(yaml.safe_dump(cfg))
        paths.append(str(p))
    return paths


def test_closed_loop_on_the_cpu_reaches_mpc_on(repo_root, tmp_path):
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    traj, pos = _tiny(repo_root, tmp_path)
    t = time.perf_counter()
    res = closed_loop.run(["--cpu", "--seconds", "2", "--time-scale", "3",
                           "--traj-config", traj, "--pos-config", pos])
    assert time.perf_counter() - t < 60.0
    assert res["fcu_status"] == FCUSim.MPC_ON, res
    assert res["device"] == "cpu" and res["tracked_ticks"] > 0 and res["solves"] > 0
    assert res["pick_ms_p50"] > 0 and res["mailbox"] in ("native", "python")
    assert res["last_state"] == "traj"


def test_closed_loop_flies_the_policy_on_the_cpu(repo_root, tmp_path):
    """``sim/closed_loop.py --solver policy`` on the tiny H = 5 configs with
    checkpoints of that horizon from ``--policy-dir`` (untrained, drawn by
    ``init_policy``) and ``--refine-iters 2``: the engine reaches
    ``MPC_ON`` and publishes the hybrid's plans."""
    import pickle

    from sde4mbrl_px4_tpu_torch.models.policy import POLICY_KIND, init_policy
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    paths = _tiny(repo_root, tmp_path)
    for kind in ("traj", "posctrl"):
        net = init_policy(torch.Generator().manual_seed(0), 5, 4, np.full(4, 1e-4),
                          np.ones(4), np.full(4, 0.6), hidden=(32, 32))
        tree = {"net": {k: v.numpy() for k, v in net.state_dict().items()},
                "meta_H": np.int32(5), "meta_n_u": np.int32(4)}
        with open(tmp_path / f"iris_{kind}_policy.pkl", "wb") as f:
            pickle.dump({"params": tree, "meta": {"kind": POLICY_KIND}}, f)
    res = closed_loop.run(["--cpu", "--seconds", "2", "--time-scale", "3", "--solver", "policy",
                           "--refine-iters", "2", "--policy-dir", str(tmp_path),
                           "--traj-config", paths[0], "--pos-config", paths[1]])
    assert res["fcu_status"] == FCUSim.MPC_ON, res
    assert res["solver"] == "policy" and res["refine_iters"] == 2
    assert res["solves"] > 0 and res["tracked_ticks"] > 0
    assert 1 <= res["iterations_p50"] <= 2


@pytest.mark.parametrize("flag, item", [(["--matmul-precision", "bfloat16"],
                                          "Reduced matmul precision")])
def test_closed_loop_refuses_what_is_not_ported(repo_root, tmp_path, flag, item):
    """A traj config at ``matmul_precision: bfloat16`` (the ROADMAP item
    that once refused it, now ported) flies the closed loop on ``--cpu``,
    where DEFAULT is fp32 as in the original's XLA there (``--log`` is
    ported too: tests/test_torch_flight_log.py)."""
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    traj, pos = _tiny(repo_root, tmp_path)
    cfg = yaml.safe_load(open(traj))
    cfg["matmul_precision"] = flag[1]
    with open(traj, "w") as f:
        yaml.safe_dump(cfg, f)
    res = closed_loop.run(["--cpu", "--time-scale", "3", "--seconds", "2",
                           "--traj-config", traj, "--pos-config", pos])
    assert res["solves"] > 0


def test_closed_loop_raises_without_a_card():
    """The engine runs on the card unless ``--cpu``: without CUDA the
    closed loop raises, naming the missing card."""
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        closed_loop.run(["--seconds", "0.1"])

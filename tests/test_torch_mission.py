"""Port, the mission layer (``cli/mission.py``) on the CPU.

- a twin of ``tests/test_mission.py`` (verbs, the command retry loop, the
  safety box, the failsafe, REPL dispatch) driven synchronously against
  the port's ``SimVehicle`` over the port's ``FCUSim`` and the shipped iris
  checkpoint, keeping its ``slow`` marks;
- parity with the JAX package's mission layer, each side over its own
  plant with the same checkpoint:
  - 50 periods of ``SimVehicle.step`` (dt 0.02) from the same state and
    setpoint: the geometric controller's motor commands agree at rtol 1e-5
    / atol 1e-6 on the first step, the plant states at rtol / atol 1e-4
    after the 50 chained steps (float32 on both sides: the plants' own
    50-step parity holds at 1e-5, ``tests/test_torch_sim.py``);
  - the same ``dispatch`` lines give the same recorded vehicle and engine
    calls and the same log lines (a recording vehicle and engine in each);
  - the safety box trips on the same tick.
"""
import os

import numpy as np
import pytest

from sde4mbrl_px4_tpu_torch.cli import mission as TM
from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle, dispatch

CKPT = "configs/models/iris_sde.pkl"


def _torch_vehicle(repo_root):
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant

    params, _ = load_params(os.path.join(repo_root, CKPT))
    return SimVehicle(FCUSim(SDEPlant(NeuralSDE.for_vehicle(iris_config()), params,
                                      sim_dt=0.005)))


def _jax_vehicle(repo_root):
    from sde4mbrl_px4_tpu.cli.mission import SimVehicle as JV
    from sde4mbrl_px4_tpu.models.params_io import load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.sim.plant import FCUSim, SDEPlant

    params, _ = load_params(os.path.join(repo_root, CKPT))
    return JV(FCUSim(SDEPlant(NeuralSDE(vehicle=iris_config()), params, sim_dt=0.005)))


@pytest.fixture
def mission(repo_root):
    veh = _torch_vehicle(repo_root)
    logs = []
    return MissionControl(veh, engine=None, log=logs.append), veh, logs


def _run(ctl, veh, seconds, dt=0.02):
    for _ in range(int(seconds / dt)):
        ctl.tick()
        veh.step(dt)


def test_arm_disarm_cycle(mission):
    ctl, veh, _ = mission
    ctl.arm()
    _run(ctl, veh, 0.1)
    assert veh.armed and not ctl.command_to_send
    ctl.disarm()
    _run(ctl, veh, 0.1)
    assert not veh.armed


def test_offboard_pushes_setpoints(mission):
    ctl, veh, _ = mission
    ctl.offboard()
    _run(ctl, veh, 0.1)
    assert veh.flight_mode == "OFFBOARD"
    assert not ctl.stop_offboard_mode


@pytest.mark.slow
def test_takeoff_reaches_altitude(mission):
    ctl, veh, _ = mission
    ctl.takeoff(z=1.0)
    _run(ctl, veh, 8.0)
    assert veh.armed and veh.flight_mode == "OFFBOARD"
    assert veh.position()[2] == pytest.approx(1.0, abs=0.25)


@pytest.mark.slow
def test_pos_moves_vehicle(mission):
    ctl, veh, _ = mission
    ctl.takeoff(z=1.0)
    _run(ctl, veh, 6.0)
    ctl.pos(x=1.0, y=0.5, z=1.0)
    _run(ctl, veh, 8.0)
    np.testing.assert_allclose(veh.position(), [1.0, 0.5, 1.0], atol=0.35)


@pytest.mark.slow
def test_relpos(mission):
    ctl, veh, _ = mission
    ctl.takeoff(z=1.0)
    _run(ctl, veh, 6.0)
    p0 = veh.position().copy()
    ctl.relpos(dx=0.5)
    _run(ctl, veh, 6.0)
    assert veh.position()[0] - p0[0] == pytest.approx(0.5, abs=0.3)


@pytest.mark.slow
def test_safety_box_triggers(mission):
    ctl, veh, logs = mission
    ctl.takeoff(z=1.0)
    _run(ctl, veh, 6.0)
    ctl.set_box(0.2, 0.2, 0.2)
    assert ctl.security_check
    ctl.pos(x=3.0)
    _run(ctl, veh, 4.0)
    assert any("Not safe" in line for line in logs)
    _run(ctl, veh, 6.0)
    assert np.linalg.norm(veh.position() - ctl.center_point) < 0.6


def test_rm_box(mission):
    ctl, veh, _ = mission
    ctl.set_box()
    ctl.rm_box()
    assert not ctl.security_check and ctl.safe_box is None


@pytest.mark.slow
def test_land(mission):
    ctl, veh, _ = mission
    ctl.takeoff(z=1.0)
    _run(ctl, veh, 6.0)
    ctl.land()
    _run(ctl, veh, 10.0)
    assert veh.position()[2] < 0.3


def test_repl_dispatch(mission):
    ctl, veh, _ = mission
    assert dispatch(ctl, "arm")
    _run(ctl, veh, 0.1)
    assert veh.armed
    assert dispatch(ctl, "takeoff z=1.5")
    assert ctl._setpoint[2] == pytest.approx(1.5)
    assert dispatch(ctl, "set_box 0.3 0.3 0.3")
    assert ctl.security_check
    assert dispatch(ctl, "unknown_verb")          # stays alive
    assert dispatch(ctl, "weight_motors 50")      # no engine -> logged, alive
    assert not dispatch(ctl, "quit")


def test_engine_verbs_without_engine(mission):
    ctl, veh, logs = mission
    ctl.controller_init()
    ctl.controller_on()
    assert any("No engine" in line for line in logs)


# ------------------------------------------------------ parity with the JAX package

def _start(veh, z_up=1.0):
    """Hover at ``z_up`` m, armed in OFFBOARD."""
    x0 = np.asarray(veh.fcu.plant.x, np.float32).copy()
    x0[:3] = [0.1, -0.2, -z_up]                  # NED: up is -z
    veh.fcu.plant.reset(x0)
    veh.arm(True)
    veh.set_flight_mode("OFFBOARD")


def test_sim_vehicle_step_equals_jax(repo_root):
    pair = {"torch": _torch_vehicle(repo_root), "jax": _jax_vehicle(repo_root)}
    cmds = {k: [] for k in pair}
    for k, veh in pair.items():
        _start(veh)
        veh.push_setpoint(np.array([0.3, -0.1, 1.2]), 0.2)
        step = veh.fcu.plant.step

        def recorded(u, dt, step=step, k=k):
            cmds[k].append(np.array(u, np.float32))
            return step(u, dt)

        veh.fcu.plant.step = recorded
        for _ in range(50):
            veh.step(0.02)
    np.testing.assert_allclose(cmds["torch"][0], cmds["jax"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pair["torch"].fcu.plant.x, np.asarray(pair["jax"].fcu.plant.x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pair["torch"].position(), pair["jax"].position(),
                               rtol=1e-4, atol=1e-4)
    assert pair["torch"].yaw() == pytest.approx(pair["jax"].yaw(), abs=1e-4)
    # the geometric law flew the vehicle: it is not where it started
    assert np.linalg.norm(pair["torch"].position() - [-0.2, 0.1, 1.0]) > 0.05


def _recorders(base):
    """A vehicle (a ``base`` subclass) and an engine that record every call."""
    calls = []

    class Vehicle(base):
        def __init__(self):
            self._armed, self._mode = False, "POSCTL"

        def arm(self, value):
            calls.append(("arm", bool(value)))
            self._armed = bool(value)

        def set_flight_mode(self, mode):
            calls.append(("mode", mode))
            self._mode = mode

        def push_setpoint(self, pos, yaw):
            calls.append(("setpoint", *np.asarray(pos, np.float64).tolist(), float(yaw)))

        def set_param(self, name, value):
            calls.append(("param", name, value))
            return name != "REJECTED"

        @property
        def armed(self):
            return self._armed

        @property
        def flight_mode(self):
            return self._mode

        def position(self):
            return np.array([0.3, -0.2, 0.5])

        def yaw(self):
            return 0.4

        def mpc_status(self):
            return 1 if len(calls) % 7 < 3 else 0

    class Engine:
        def initialize_mpc(self):
            calls.append(("init",))
            return True

        def set_mode(self, mode, target_pose=None, weight_motors=110):
            calls.append(("set_mode", int(mode), *np.asarray(target_pose, np.float64).tolist(),
                          int(weight_motors)))
            return True, f"mode {mode} weight {weight_motors}"

    return Vehicle(), Engine(), calls


_LINES = ["arm", "offboard", "takeoff z=1.5", "pos 1 2 3", "relpos dx=0.5 dyaw=0.1",
          "set_box 0.3 0.3 0.3", "rm_box", "controller_init", "controller_on",
          "controller_idle", "controller_test", "weight_motors 50", "weight_motors 150",
          "ctrl_pos 0.5 0.5 1.0", "ctrl_pos_current", "controller_off", "pos x=oops",
          "land", "disarm", "push_params {params}", "unknown_verb", "help"]


def test_dispatch_records_the_same_calls_as_jax(tmp_path, capsys):
    from sde4mbrl_px4_tpu.cli import mission as JM
    from sde4mbrl_px4_tpu_torch.io.px4_params import dump_params_file

    params = str(tmp_path / "m.params")
    dump_params_file(params, {"MPC_TILTMAX_AIR": 25.0, "REJECTED": 1})
    runs = {}
    for tag, mod in (("torch", TM), ("jax", JM)):
        veh, eng, calls = _recorders(mod.VehicleBase)
        logs = []
        ctl = mod.MissionControl(veh, engine=eng, log=logs.append)
        for line in _LINES:
            assert mod.dispatch(ctl, line.format(params=params))
            ctl.tick()
        assert not mod.dispatch(ctl, "exit")
        runs[tag] = (calls, logs, capsys.readouterr().out)
    (ct, lt, ot), (cj, lj, oj) = runs["torch"], runs["jax"]
    assert [c[0] for c in ct] == [c[0] for c in cj] and len(ct) > 30
    for a, b in zip(ct, cj):
        if a[0] in ("setpoint", "set_mode"):
            np.testing.assert_allclose(a[1:], b[1:], rtol=1e-6, atol=1e-7)
        else:
            assert a == b
    assert lt == lj and ot == oj
    assert any("Weight motors must be between 0 and 100" in line for line in lt)
    assert "error:" in ot and "Unknown command" in ot


def test_safety_box_trips_on_the_same_tick_as_jax(repo_root):
    from sde4mbrl_px4_tpu.cli.mission import MissionControl as JaxControl

    ticks = {}
    for tag, make, Ctl in (("torch", _torch_vehicle, MissionControl),
                           ("jax", _jax_vehicle, JaxControl)):
        veh = make(repo_root)
        _start(veh)
        logs = []
        ctl = Ctl(veh, engine=None, log=logs.append)
        ctl.offboard()
        ctl.set_box(0.2, 0.2, 0.2)
        ctl.pos(x=3.0)
        for k in range(150):
            ctl.tick()
            if any("Not safe" in line for line in logs):
                ticks[tag] = k
                break
            veh.step(0.02)
    assert "torch" in ticks and ticks["torch"] == ticks.get("jax"), ticks
    assert ticks["torch"] > 5

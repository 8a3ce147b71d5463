"""Port, the full SITL stack (``sim/full_sitl_stack.py``) and its pieces on
the CPU.

- the router on the shipped ``configs/router_sitl.conf`` (its ports moved
  to free ones) between the port's ``FCUSimNode`` and a fake engine socket:
  ``MPC_FULL_STATE`` (367) reaches the engine side, its ``MPC_MOTORS_CMD``
  (368) reaches the FCU shim, and the unfiltered and tap endpoints see both;
- a port of the stack that is in use makes the drive stop at once, naming
  the port, before it starts anything;
- ``slow``: the whole drive with ``--cpu`` on the tiny configs of
  ``tests/test_engine_runtime.py:21-30`` (as ``tests/test_full_stack.py:32``
  runs its routed stack): the engine in its own process, the mission's
  graduated engagement, the FCU handing authority to the MPC. The 0.25 m
  station-keeping gate is held on the card (``chip_smoke.py`` phase 27).
"""
import os
import socket
import time

import numpy as np
import pytest
import yaml

from sde4mbrl_px4_tpu_torch.io import mavlink as M
from sde4mbrl_px4_tpu_torch.sim import full_sitl_stack as FS


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conf(repo_root, tmp_path, ports: dict) -> str:
    """The shipped conf with its endpoints' ports replaced by ``ports``."""
    with open(os.path.join(repo_root, "configs", "router_sitl.conf")) as f:
        text = f.read()
    for old, new in ports.items():
        text = text.replace(f"Port = {old}", f"Port = {new}")
    path = tmp_path / "router.conf"
    path.write_text(text)
    return str(path)


def test_router_on_shipped_conf_carries_states_out_and_commands_back(repo_root, tmp_path):
    from sde4mbrl_px4_tpu_torch.io.router import (
        NativeRouter, Router, native_router_supports, parse_conf)
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant
    from sde4mbrl_px4_tpu_torch.sim.sitl import FCUSimNode

    socks = {}
    for name in ("engine", "telemetry", "liveview"):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(5.0)
        socks[name] = s
    fcu_port = _free_port()
    conf = _conf(repo_root, tmp_path, {14550: fcu_port,
                                       14998: socks["engine"].getsockname()[1],
                                       14999: socks["telemetry"].getsockname()[1],
                                       14996: socks["liveview"].getsockname()[1]})
    endpoints = parse_conf(open(conf).read())
    router = (NativeRouter if native_router_supports(endpoints) else Router)(endpoints)
    router.start()
    params, _ = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    fcu = FCUSim(SDEPlant(NeuralSDE.for_vehicle(iris_config()), params, sim_dt=0.005),
                 state_rate_hz=50.0)
    node = FCUSimNode(fcu, addr=f"127.0.0.1:{fcu_port}")
    node.start()
    seen = {k: set() for k in socks}
    try:
        data, peer = socks["engine"].recvfrom(512)
        msg = M.decode_frame(data)
        assert msg is not None and msg.get_type() == "MPC_FULL_STATE"
        np.testing.assert_allclose(np.linalg.norm(msg.state[6:10]), 1.0, atol=1e-3)
        # the engine answers the router's mpc endpoint, which lets 368 in
        socks["engine"].sendto(bytes(M.encode_motors_cmd(
            int(time.time() * 1e6), np.full(6, 0.6), [0.6, 0, 0, 0], 3, 100)), peer)
        deadline = time.time() + 5.0
        while fcu.last_cmd is None and time.time() < deadline:
            time.sleep(0.01)
        for name in ("telemetry", "liveview"):
            while len(seen[name]) < 2 and time.time() < deadline:
                m = M.decode_frame(socks[name].recvfrom(512)[0])
                if m is not None:
                    seen[name].add(m.get_type())
        stats = router.stats
    finally:
        node.stop()
        router.stop()
        for s in socks.values():
            s.close()
    assert fcu.last_cmd is not None and fcu.last_cmd[2:] == (3, 100)
    np.testing.assert_allclose(fcu.last_cmd[0][:4], 0.6, atol=1e-6)
    for name in ("telemetry", "liveview"):
        assert seen[name] == {"MPC_FULL_STATE", "MPC_MOTORS_CMD"}, (name, seen)
    assert stats["fcu"] > 0 and stats["mpc"] == 1


def test_stack_stops_at_once_naming_a_port_in_use(repo_root, tmp_path, capsys):
    fcu_port, mpc_port, svc_port = _free_port(), _free_port(), _free_port()
    conf = _conf(repo_root, tmp_path, {14550: fcu_port, 14998: mpc_port})
    for taken, what in ((fcu_port, "the router's fcu endpoint"),
                        (mpc_port, "the engine's MAVLink side-channel"),
                        (svc_port, "the engine's services")):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as holder:
            holder.bind(("127.0.0.1", taken))
            t0 = time.perf_counter()
            with pytest.raises(OSError, match=f"UDP port {taken} on 127.0.0.1 \\({what}\\)"):
                FS.run(["--conf", conf, "--svc-port", str(svc_port), "--cpu"])
            assert FS.main(["--conf", conf, "--svc-port", str(svc_port), "--cpu"]) == 2
            assert time.perf_counter() - t0 < 5.0
        assert f"error: full_sitl_stack: UDP port {taken}" in capsys.readouterr().out


def _tiny_cfg(repo_root, with_traj):
    cfg = yaml.safe_load(open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg.update(horizon=5, num_short_dt=5)
    cfg["apg_mpc"].update(max_iter=10, max_no_improvement_iter=10)
    cfg["learned_model_params"] = os.path.join(repo_root, "configs/models/iris_sde.pkl")
    if with_traj:
        cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
    return cfg


@pytest.mark.slow
def test_full_stack_engages_mpc_on_cpu(repo_root, tmp_path):
    """States flow plant -> router -> engine process, commands come back
    through the router's AllowMsgIdIn filter, the mission's graduated
    engagement hands authority to the MPC, and every process stops."""
    (tmp_path / "traj.yaml").write_text(yaml.safe_dump(_tiny_cfg(repo_root, True)))
    (tmp_path / "pos.yaml").write_text(yaml.safe_dump(_tiny_cfg(repo_root, False)))
    conf = _conf(repo_root, tmp_path, {p: _free_port() for p in (14550, 14996, 14998, 14999)})
    res = FS.run(["--cpu", "--seconds", "3", "--conf", conf, "--svc-port", str(_free_port()),
                  "--traj-config", str(tmp_path / "traj.yaml"),
                  "--pos-config", str(tmp_path / "pos.yaml")])
    assert res["takeoff_ok"] and res["engaged"], res
    assert res["router_stats"]["fcu"] > 0 and res["router_stats"]["mpc"] > 0, res
    assert res["engine_state"] == "pos" and res["engine_num_steps"] > 0, res
    assert res["engine_rc"] == 0 and np.isfinite(res["err_mean_m"]), res
    assert res["engine_plans"] > 0 and not any(res["engine_launches"].values()), res

"""Closed-loop flight of the native geometric baseline against the simulated
FCU over UDP MAVLink.

The port's counterpart of ``examples/geometric_baseline_sim.py``, with its
options and its gate (mean tracking error below 0.6 m after the 2 s entry
transient, FCU status ``MPC_ON``)::

    python -m sde4mbrl_px4_tpu_torch.sim.geometric_baseline [--seconds 6]

Topology (the reference's geoctrl.launch and router)::

    FCUSim --MPC_FULL_STATE--> geometric node (csrc C++) --thrust+rates-->

The controller (``baselines/geometric.py::NativeGeometricController`` over
``csrc/libmpc_native.so``, ``make -C csrc``) follows
``configs/trajs/circle.csv`` with its differential-flatness pipeline; its
commands run through the FCU's rate loop (``weight_motors`` 0). The plant
is the shipped iris SDE (``sim/plant.py::SDEPlant``) on the host CPU: no
card is used.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PASS_MEAN_M = 0.6      # the example's gate (:119)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.geometric_baseline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--port", type=int, default=0,
                    help="the node's UDP port (0: a free one)")
    ap.add_argument("--state-rate", type=float, default=50.0)
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Fly the baseline; returns its numbers (``ok`` is the gate)."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.baselines.geometric import GeoParams, NativeGeometricController
    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned, ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES
    from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.trajectory import load_trajectory_csv, make_state_from_traj
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant

    csv = os.path.join(_ROOT, "configs/trajs/circle.csv")
    # --- the geometric node (a UDP server, like launch_geometric) ----------
    ctl = NativeGeometricController(GeoParams(
        norm_thrust_const=0.71 / 9.81, norm_thrust_offset=0.0,
        kp=(2.0, 2.0, 4.0), kv=(2.0, 2.0, 3.0)))
    if not ctl.load_trajectory(csv):
        raise FileNotFoundError(csv)
    srv = MavlinkUDP(f"127.0.0.1:{args.port}", mode="udpin")
    port = srv.sock.getsockname()[1]
    stop = threading.Event()

    def node_loop():
        while not stop.is_set():
            msg = srv.recv_match(type="MPC_FULL_STATE", timeout=0.1)
            if msg is None:
                continue
            x_enu = ned2enu(torch.as_tensor(np.asarray(msg.state, np.float32))).numpy()
            pos, vel, acc, yaw = ctl.sample_trajectory(msg.time_usec / 1e6)
            cmd, _ = ctl.update(x_enu.astype(np.float64), pos, vel, acc, yaw)
            tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
            srv.send_motors_cmd(msg.time_usec, np.zeros(6, np.float32), tr,
                                CONTROL_STATES["pos"], 0)

    # --- the FCU side ---------------------------------------------------------
    params, _ = load_params(os.path.join(_ROOT, "configs/models/iris_sde.pkl"))
    plant = SDEPlant(NeuralSDE.for_vehicle(iris_config(), "cpu"), params, sim_dt=0.005)
    sft = make_state_from_traj(load_trajectory_csv(csv, convert_to_ned=False))
    plant.reset(enu2ned(sft(0.0)).numpy())
    fcu = FCUSim(plant, state_rate_hz=args.state_rate)
    link = MavlinkUDP(f"127.0.0.1:{port}", mode="udpout")

    def rx_loop():
        while not stop.is_set():
            m = link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
            if m is not None:
                fcu.push_cmd(m.motor_val_des, m.thrust_and_angrate_des,
                             m.mpc_on, m.weight_motors)

    threads = [threading.Thread(target=f, daemon=True) for f in (node_loop, rx_loop)]
    for th in threads:
        th.start()
    state_dt = 1.0 / args.state_rate
    errs = []
    try:
        for _ in range(int(args.seconds / state_dt)):
            x, t_usec = fcu.full_state_msg()
            link.send_full_state(int(t_usec), x)
            time.sleep(0.004)
            fcu.run_control_period(state_dt)
            if plant.t > 2.0:               # past the trajectory-entry transient
                ref = enu2ned(sft(plant.t)).numpy()
                errs.append(float(np.linalg.norm(plant.x[:3] - ref[:3])))
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=1.0)
        srv.close()
        link.close()
    errs = np.asarray(errs) if errs else np.asarray([np.inf])
    res = {"err_mean_m": float(errs.mean()), "err_max_m": float(errs.max()),
           "ticks": int(len(errs)), "fcu_status": int(fcu.status)}
    res["ok"] = bool(res["err_mean_m"] < PASS_MEAN_M and fcu.status == FCUSim.MPC_ON)
    print(f"geometric baseline tracking: mean={res['err_mean_m']:.3f}m "
          f"max={res['err_max_m']:.3f}m over {res['ticks']} ticks, fcu_status={fcu.status}")
    print("RESULT:", "PASS" if res["ok"] else "FAIL", flush=True)
    return res


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

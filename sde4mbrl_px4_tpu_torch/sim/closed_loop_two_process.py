"""Two-process closed loop: the engine node in its own process, the FCU
simulator in this one.

The port's counterpart of ``examples/closed_loop_two_process.py``, with its
options, prints and gate: the reference's deployment topology, the
controller node and the FCU as separate OS processes over MAVLink::

    this process                          subprocess (launch.py)
    FCUSim (CPU plant)  --MPC_FULL_STATE-->  SDEControlNode (solves on the card)
         ^------------- MPC_MOTORS_CMD ------------/
         service client --JSON/UDP--> services (init / set_mode / status)

    python -m sde4mbrl_px4_tpu_torch.sim.closed_loop_two_process [--seconds 6]
        [--mission pos|traj] [--cpu]

The engine is ``python -m sde4mbrl_px4_tpu_torch.launch`` on a launch file
written for the run (``--cpu``: the engine on the CPU); this process never
touches CUDA, so the plant's stepping is never serialised behind a solve.
The default mission holds position: a 1 m offset recovered, then station
keeping at ENU (0, 0, 1); ``--mission traj`` flies the lemniscate (the
reference's idle targets the trajectory's start state with its velocity,
so the engagement transient varies from run to run). The sim is paced to
wall time, the engine's clock. ``RESULT: PASS`` when the mean tracking
error is under 0.2 m (pos, from 3 s on) or 0.5 m (traj, from 2 s after
activation) with the FCU at ``MPC_ON`` (the original's ``:175-197``).
``--traj-config`` / ``--pos-config`` replace the shipped iris configs.
``--time-scale`` S flies in slow motion: both processes' clocks run at
wall time / S (the launcher's ``--time-scale``), so an engine on the CPU,
whose plain solves take tens of ms an iteration, keeps up with the plant
in the sim's seconds (as ``sim/closed_loop.py --time-scale``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sde4mbrl_px4_tpu_torch.sim.closed_loop_two_process",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--mav-port", type=int, default=24998)
    ap.add_argument("--svc-port", type=int, default=24997)
    ap.add_argument("--state-rate", type=float, default=50.0)
    ap.add_argument("--ready-timeout", type=float, default=900.0)
    ap.add_argument("--mission", choices=("pos", "traj"), default="pos")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="slow motion: both clocks at wall time / this")
    ap.add_argument("--traj-config", default=None,
                    help="the engine's trajectory config (default: configs/iris_traj_mpc.yaml)")
    ap.add_argument("--pos-config", default=None,
                    help="the engine's position config (default: configs/iris_posctrl_mpc.yaml)")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.core.types import (
        CTRL_POSE_ACTIVE, CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE, hover_state)
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import EngineServiceClient
    from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.trajectory import load_trajectory_csv, make_state_from_traj
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant

    configs = os.path.join(_ROOT, "configs")
    traj = os.path.abspath(args.traj_config or os.path.join(configs, "iris_traj_mpc.yaml"))
    pos = os.path.abspath(args.pos_config or os.path.join(configs, "iris_posctrl_mpc.yaml"))
    launch_cfg = (f"node: sde_control\n"
                  f"addr_mavlink_state_msg: 127.0.0.1:{args.mav_port}\n"
                  f"addr_services: 127.0.0.1:{args.svc_port}\n"
                  f"config_dir: /\ntraj_ctrl: {traj}\nsp_ctrl: {pos}\n"
                  f"seed: 0\nmpc_report_dt: 1.0\n")
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(launch_cfg)
        launch_path = f.name

    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", launch_path,
         "--time-scale", str(args.time_scale)] + (["--cpu"] if args.cpu else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=_ROOT)
    print("== waiting for engine READY (building the kernels on a first run) ==", flush=True)
    ready = False
    t0 = time.time()

    def _reader():
        nonlocal ready
        for line in proc.stdout:
            if "[launch]" in line:
                print(" ", line.strip(), flush=True)
            if "READY" in line:
                ready = True

    rd = threading.Thread(target=_reader, daemon=True)
    rd.start()
    try:
        while not ready and time.time() - t0 < args.ready_timeout:
            if proc.poll() is not None:
                print("engine subprocess exited early")
                return 1
            time.sleep(0.5)
        if not ready:
            print("engine never became ready")
            return 1
        print(f"== engine ready in {time.time() - t0:.0f}s ==", flush=True)

        # ---- FCU sim side (this process, CPU) -----------------------------
        params, _ = load_params(os.path.join(configs, "models", "iris_sde.pkl"))
        plant = SDEPlant(NeuralSDE.for_vehicle(iris_config()), params, sim_dt=0.005)
        sft = make_state_from_traj(load_trajectory_csv(
            os.path.join(configs, "trajs", "lemniscate.csv"), convert_to_ned=False))
        to_ned = lambda t: enu2ned(sft(torch.tensor(float(t)))).numpy()
        if args.mission == "traj":
            plant.reset(to_ned(0.0))
        else:
            x_start = hover_state().numpy().copy()
            x_start[0] = 1.0          # 1 m offset to recover (NED)
            x_start[2] = -1.0
            plant.reset(x_start)
        fcu = FCUSim(plant, state_rate_hz=args.state_rate)

        link = MavlinkUDP(f"127.0.0.1:{args.mav_port}", mode="udpout")
        svc = EngineServiceClient(f"127.0.0.1:{args.svc_port}", timeout=5.0)
        stop = threading.Event()

        def rx_loop():
            while not stop.is_set():
                m = link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
                if m is not None:
                    fcu.push_cmd(m.motor_val_des, m.thrust_and_angrate_des,
                                 m.mpc_on, m.weight_motors)

        rx = threading.Thread(target=rx_loop, daemon=True)
        rx.start()

        if not svc.initialize_mpc():
            raise RuntimeError("controller_init failed")
        if args.mission == "traj":
            ok, msg = svc.set_mode(CTRL_TRAJ_IDLE)
            print("idle:", ok, msg)
        else:
            tgt = hover_state().numpy().copy()
            tgt[2] = 1.0              # hold at ENU (0, 0, 1)
            ok, msg = svc.set_mode(CTRL_POSE_ACTIVE, target_pose=tgt)
            print("pose mode:", ok, msg)
        svc.set_mode(0, weight_motors=100)

        # the engine's trajectory clock is wall time (/ S): the sim is paced
        # to it, as a real FCU would be
        S = float(args.time_scale)
        clock = lambda: time.time() / S
        state_dt = 1.0 / args.state_rate
        errs = []
        started = None
        wall0 = time.time()
        for k in range(int(args.seconds / state_dt)):
            x, _ = fcu.full_state_msg()
            # stamped with the engine's clock, so the plan's index matches it
            link.send_full_state(int(clock() * 1e6), x)
            sleep = wall0 + (k + 1) * state_dt * S - time.time()
            if sleep > 0:
                time.sleep(sleep)
            fcu.run_control_period(state_dt)
            if args.mission == "traj" and k == int(1.0 / state_dt):
                ok, msg = svc.set_mode(CTRL_TRAJ_ACTIVE)
                print("activate:", ok, msg, flush=True)
                started = clock()
            if args.mission == "traj" and started is not None:
                t_traj = clock() - started
                if t_traj > 2.0:
                    errs.append(float(np.linalg.norm(plant.x[:3] - to_ned(t_traj)[:3])))
            elif args.mission == "pos" and k * state_dt > 3.0:
                errs.append(float(np.linalg.norm(plant.x[:3] - np.array([0.0, 0.0, -1.0]))))

        st = svc.status()
        wall_elapsed = (time.time() - wall0) / S
        print(f"pacing: sim={plant.t:.2f}s wall={wall_elapsed:.2f}s"
              f"{f' (/ {S:g})' if S != 1.0 else ''} slip={wall_elapsed - plant.t:+.2f}s",
              flush=True)
        stop.set()
        rx.join(timeout=1.0)
        link.close()
        svc.close()
        errs = np.asarray(errs) if errs else np.asarray([np.inf])
        print(f"engine telemetry: steps={st.get('num_steps')} "
              f"solve={1e3 * st.get('solve_time', 0):.1f}ms state={st.get('ctrl_state')} "
              f"idx={st.get('mpc_indx')}")
        print(f"tracking error over {len(errs)} ticks: "
              f"mean={errs.mean():.3f}m max={errs.max():.3f}m fcu={fcu.status}")
        bar = 0.5 if args.mission == "traj" else 0.2
        ok = errs.mean() < bar and fcu.status == FCUSim.MPC_ON
        print("RESULT:", "PASS" if ok else "FAIL", flush=True)
        return 0 if ok else 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
        os.unlink(launch_path)


if __name__ == "__main__":
    sys.exit(main())

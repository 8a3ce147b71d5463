"""Full SITL stack: every layer of the reference topology, end to end.

PyTorch counterpart of ``examples/full_sitl_stack.py``. The reference brings
up PX4 SITL + Gazebo, mavlink-routerd fanning the FCU stream out with
message-id filters (``scripts/sitl_route_mavlink.sh`` + ``router_sitl.conf``),
the MPC node on the filtered side-channel (``iris_sdectrl.launch``) and the
mission CLI driving arming, offboard, takeoff and the controller lifecycle
(``basic_control.py``). This drive is that topology with the port's
components::

    this process (host CPU only)              subprocess (launch tier)
    ----------------------------              ------------------------
    FCUSim + SimVehicle (plant + PX4          SDEControlNode on the card
      position-loop stand-in)                   (``--cpu``: on the CPU)
        | MPC_FULL_STATE (367)                      ^  367 only
        v                                           |
    router (io/router.py, the conf) ---------------+
        |        \\ full stream                     |  368 back in
        v         v                                 v
    liveview   telemetry                    MPC_MOTORS_CMD -> router -> FCU
    (14996)    (14999)

``MissionControl`` drives arm -> offboard -> takeoff 1 m ->
``controller_init`` -> ``controller_test`` -> ``weight_motors 100`` ->
``ctrl_pos_current`` (the reference's graduated engagement), then keeps
station for ``--seconds``: ``RESULT: PASS`` when the FCU handed authority to
the MPC and the mean distance to the held setpoint (from 1 s after the
handover) is below 0.25 m. The line before it is the run's numbers as one
JSON object (the engine's plans and its process's kernel launches among
them).

The router and the engine bind the conf's ``fcu`` port, the ``mpc`` port
and the services port; the drive checks they are free first and stops
naming the one that is taken. ``liveview`` (14996) and ``telemetry``
(14999) are where the router sends: ``python -m
sde4mbrl_px4_tpu_torch.sim.analyze --live 127.0.0.1:14996`` attaches to the
tap while the stack flies. The router is the native core over
``csrc/libmpc_native.so`` when it is built (``make -C csrc``), else the
Python twin; the router line says which. Nothing in this process touches
CUDA: the card belongs to the engine's process.

Run it on an otherwise idle host: the engaged loop's margin is real-time
slack, and a starved sim thread trips the FCU's 20 ms watchdog.

    python -m sde4mbrl_px4_tpu_torch.sim.full_sitl_stack [--seconds 8] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

__all__ = ["check_ports", "parser", "run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PASS_MEAN_M = 0.25


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.full_sitl_stack",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="station-keeping window after MPC engagement")
    ap.add_argument("--ready-timeout", type=float, default=900.0)
    ap.add_argument("--conf", default=os.path.join(_ROOT, "configs", "router_sitl.conf"),
                    help="the router conf: its fcu and mpc endpoints place the plant "
                         "and the engine")
    ap.add_argument("--svc-port", type=int, default=14997,
                    help="the engine's JSON service port")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    ap.add_argument("--traj-config", default=os.path.join(_ROOT, "configs",
                                                          "iris_traj_mpc.yaml"))
    ap.add_argument("--pos-config", default=os.path.join(_ROOT, "configs",
                                                         "iris_posctrl_mpc.yaml"))
    return ap


def check_ports(binds: List[tuple]) -> None:
    """Raise ``OSError`` naming the first ``(host, port, what)`` that cannot
    be bound, before anything of the stack starts."""
    for host, port, what in binds:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                s.bind((host, port))
            except OSError as e:
                raise OSError(f"full_sitl_stack: UDP port {port} on {host} ({what}) is in "
                              f"use ({e.strerror}); stop what holds it, or pass --conf / "
                              f"--svc-port with free ports") from None


def _endpoint(endpoints, name: str):
    for e in endpoints:
        if e.name == name:
            return e
    raise ValueError(f"the router conf has no [UdpEndpoint {name}]")


def _start_engine(args, mpc, tmpdir: str):
    """The engine node through the launch tier in a fresh process; returns
    the process, its collected lines, the flag set at READY and the thread
    that reads them."""
    launch_path = os.path.join(tmpdir, "engine.yaml")
    with open(launch_path, "w") as f:
        f.write(f"node: sde_control\n"
                f"addr_mavlink_state_msg: {mpc.address}:{mpc.port}\n"
                f"addr_services: 127.0.0.1:{args.svc_port}\n"
                f"config_dir: {os.path.dirname(os.path.abspath(args.traj_config))}\n"
                f"traj_ctrl: {os.path.abspath(args.traj_config)}\n"
                f"sp_ctrl: {os.path.abspath(args.pos_config)}\n"
                f"seed: 0\nmpc_report_dt: 1.0\n")
    cmd = [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", launch_path]
    proc = subprocess.Popen(cmd + (["--cpu"] if args.cpu else []), cwd=_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    ready = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "[launch]" in line:
                print(" ", line.strip(), flush=True)
            if "[launch] READY" in line:
                ready.set()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    return proc, lines, ready, th


def _stop(proc) -> int:
    if proc.poll() is None:
        proc.terminate()
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def run(argv: Optional[list] = None) -> dict:
    """Bring the stack up, fly the mission, tear it down; returns its
    numbers (``ok`` is the PASS gate). Raises ``OSError`` naming a port
    that is taken, before anything starts."""
    args = parser().parse_args(argv)

    from sde4mbrl_px4_tpu_torch.io.router import (
        NativeRouter, Router, native_router_supports, parse_conf)

    with open(args.conf) as f:
        endpoints = parse_conf(f.read())
    fcu_ep, mpc = _endpoint(endpoints, "fcu"), _endpoint(endpoints, "mpc")
    check_ports([(fcu_ep.address, fcu_ep.port, "the router's fcu endpoint"),
                 (mpc.address, mpc.port, "the engine's MAVLink side-channel"),
                 ("127.0.0.1", args.svc_port, "the engine's services")])

    # ---- L1: the MAVLink fan-out (reference sitl_route_mavlink.sh) --------
    native = native_router_supports(endpoints)
    router = (NativeRouter if native else Router)(endpoints)
    router.start()
    out = {"router": "native C++" if native else "python", "ok": False}
    print(f"== router ({out['router']}) up: {', '.join(e.name for e in endpoints)} ==",
          flush=True)
    proc = None
    try:
        with tempfile.TemporaryDirectory(prefix="full_sitl_stack_") as td:
            # ---- L4/L5: the engine node in its own process ---------------
            t0 = time.perf_counter()
            proc, engine_lines, ready, reader = _start_engine(args, mpc, td)
            print("== waiting for engine READY (kernels build on a first run) ==", flush=True)
            while not ready.wait(0.5):
                if proc.poll() is not None or time.perf_counter() - t0 > args.ready_timeout:
                    raise RuntimeError("the engine never became ready: "
                                       + " | ".join(engine_lines[-15:]))
            out["ready_s"] = time.perf_counter() - t0
            print(f"== engine ready in {out['ready_s']:.1f} s ==", flush=True)
            out.update(_fly(args, router, fcu_ep))
            print(f"router ({out['router']}) frames in per endpoint: {out['router_stats']}",
                  flush=True)
    finally:
        if proc is not None:
            out["engine_rc"] = _stop(proc)
            reader.join(timeout=10)
            out.update(_engine_totals(engine_lines))
        router.stop()
    return out


def _engine_totals(lines: list) -> dict:
    """The plans the engine published and its process's kernel launches,
    from the line the launcher prints when the engine stops."""
    for line in lines:
        if line.startswith("[launch] engine stopped:"):
            plans = int(line.split("stopped: ")[1].split()[0])
            return {"engine_plans": plans,
                    "engine_launches": json.loads(line.split("kernel launches ", 1)[1])}
    return {}


def _fly(args, router, fcu_ep) -> dict:
    """The plant, the FCU node and the mission over the running router and
    engine: arm, take off, engage, keep station; returns the readings."""
    from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, SimVehicle
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import EngineServiceClient
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim, SDEPlant
    from sde4mbrl_px4_tpu_torch.sim.sitl import FCUSimNode

    # ---- L0: the plant, streaming INTO the router's FCU endpoint ---------
    params, _ = load_params(os.path.join(_ROOT, "configs/models/iris_sde.pkl"))
    # 50 Hz states: the commands come back one per state, on the 20 ms
    # staleness bound, so the watchdog may flap; each dropout falls back to
    # a hold at the CURRENT position (SimVehicle.step), which is benign.
    plant = SDEPlant(NeuralSDE.for_vehicle(iris_config()), params, sim_dt=0.005)
    fcu = FCUSim(plant, state_rate_hz=50.0)
    veh = SimVehicle(fcu)
    node = FCUSimNode(fcu, addr=f"{fcu_ep.address}:{fcu_ep.port}", step_fn=veh.step)
    node.start()
    svc = EngineServiceClient(f"127.0.0.1:{args.svc_port}", timeout=5.0)
    logs: list = []
    ctl = MissionControl(veh, engine=svc, auto_spin=True,
                         log=lambda m: (logs.append(m), print("  [ctl]", m, flush=True)))
    res = {"mission_log": logs}
    try:
        # ---- L6: the mission layer ---------------------------------------
        ctl.arm()
        ctl.wait_for_command()
        ctl.offboard()
        ctl.wait_for_command()
        ctl.takeoff(z=1.0)
        res["takeoff_ok"] = ctl.wait_for_action(timeout=30.0)
        print(f"takeoff complete={res['takeoff_ok']} pos={np.round(veh.position(), 2)}",
              flush=True)
        ctl.controller_init()
        time.sleep(0.3)
        # graduated engagement (the reference's protocol): CTRL_TEST first,
        # the solver on real states with its commands sent but ignored by
        # the FCU, so the pos solver's warm start converges before the
        # handover; then motor passthrough, then the position mode.
        ctl.controller_test()
        time.sleep(1.0)
        ctl.weight_motors(100)
        t_cmd = time.perf_counter()
        ctl.ctrl_pos_current()          # CTRL_POSE_ACTIVE at the current setpoint

        t_engaged = None
        errs = []
        target = ctl._setpoint.copy()
        t_end = time.time() + args.seconds + 10.0
        while time.time() < t_end:
            time.sleep(0.1)
            if fcu.status == FCUSim.MPC_ON and t_engaged is None:
                t_engaged = time.time()
                res["engage_s"] = time.perf_counter() - t_cmd
                print(f"== MPC engaged (authority handed over) "
                      f"{res['engage_s']:.2f} s after ctrl_pos_current ==", flush=True)
            if t_engaged is not None and time.time() - t_engaged > 1.0:
                errs.append((time.time() - t_engaged,
                             float(np.linalg.norm(veh.position() - target))))
            if t_engaged is not None and time.time() - t_engaged > args.seconds:
                break
        st = svc.status()
        ctl.controller_off()
    finally:
        ctl.stop()
        node.stop()
        svc.close()
    errs = np.asarray(errs) if errs else np.asarray([[0.0, np.inf]])
    res.update(engaged=t_engaged is not None, err_mean_m=float(errs[:, 1].mean()),
               err_max_m=float(errs[:, 1].max()), ticks=len(errs),
               router_stats=dict(router.stats), engine_num_steps=st.get("num_steps"),
               engine_solve_ms=1e3 * float(st.get("solve_time", 0.0)),
               engine_state=st.get("ctrl_state"), engine_mpc_indx=st.get("mpc_indx"),
               fcu_status=int(fcu.status))
    res["ok"] = bool(res["engaged"] and res["err_mean_m"] < PASS_MEAN_M)
    print(f"engine telemetry: steps={res['engine_num_steps']} "
          f"solve={res['engine_solve_ms']:.1f}ms state={res['engine_state']} "
          f"idx={res['engine_mpc_indx']}", flush=True)
    print(f"station keeping over {res['ticks']} ticks: mean={res['err_mean_m']:.3f}m "
          f"max={res['err_max_m']:.3f}m engaged={res['engaged']}", flush=True)
    if not res["ok"]:
        for i in range(0, len(errs), max(1, len(errs) // 12)):
            print(f"  t+{errs[i, 0]:5.1f}s err={errs[i, 1]:9.3f} m", flush=True)
    return res


def main(argv: Optional[list] = None) -> int:
    try:
        res = run(argv)
    except OSError as e:
        print(f"error: {e}", flush=True)
        return 2
    print(json.dumps({k: v for k, v in res.items() if k != "mission_log"}), flush=True)
    print("RESULT:", "PASS" if res["ok"] else "FAIL", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Node launcher (L7) — the roslaunch tier, ROS-free.

PyTorch counterpart of ``sde4mbrl_px4_tpu/launch.py`` (``:36-66``,
``:201-227``). A launch YAML names the node type and its parameters::

    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_px4_sitl.yaml &
    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_sdectrl.yaml

- ``node: sde_control`` — the async MPC engine (``io/engine_runtime.py``)
  on the card (``--cpu``: on the CPU), serving the MAVLink UDP side-channel
  and the JSON service channel; with ``--repl`` the mission REPL
  (``cli/mission.py``) reads operator verbs from stdin and drives the
  engine's services in-process (no vehicle: engine verbs only), and the
  process exits 0 on EOF or ``exit``;
- ``node: fcu_sim`` — the SITL plant (``sim/sitl.py``; the plant runs on
  the host CPU);
- ``node: geometric_controller`` — the native geometric baseline
  (``baselines/geometric.py::NativeGeometricController`` over
  ``csrc/libmpc_native.so``, ``make -C csrc``) following the launch file's
  trajectory on the MAVLink side-channel (the original's ``:104-153``;
  the trajectory's clock starts at the first state): each
  ``MPC_FULL_STATE`` it receives is answered with an ``MPC_MOTORS_CMD`` of
  thrust and FRD body rates (``weight_motors`` 0);
- ``node: router`` — the MAVLink fan-out (``io/router.py``) on the launch
  file's ``conf`` (resolved against the working directory, then the launch
  file's directory): the native core over ``csrc/libmpc_native.so`` when
  it is built and has what the conf needs, else (or with ``native: false``
  in the launch file) the Python twin; the line before READY says which
  runs.

Each node prints ``[launch] READY`` once it serves, then runs until
interrupted (SIGINT or SIGTERM), or for ``--seconds``, and stops its
threads; the engine then prints the plans it published and its process's
kernel launches (``[launch] engine stopped: ...``), the count a caller in
another process can read. Start a second node as a fresh process
(``subprocess``), never by forking one that has initialised CUDA. There is
no ``--coordinator`` (multi-host is ``torch.distributed``, ROADMAP
'Batched and fleet').
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
from typing import Any, Callable, Dict, Optional

import yaml

__all__ = ["kernel_launches", "launch_from_file", "main"]


def _load(path: str) -> Dict[str, Any]:
    with open(os.path.expanduser(path)) as f:
        cfg = yaml.safe_load(f)
    cfg["_dir"] = os.path.dirname(os.path.abspath(path))
    return cfg


def config_dir(cfg: Dict[str, Any]) -> str:
    """``config_dir`` resolved against the working directory first, then
    against the launch file's grandparent (launch files live in
    ``<root>/configs/launch``)."""
    base = cfg.get("config_dir", "configs")
    if os.path.isabs(base):
        return base
    cand = [os.path.abspath(base),
            os.path.join(os.path.dirname(os.path.dirname(cfg["_dir"])), base)]
    return next((c for c in cand if os.path.isdir(c)), cand[0])


def _serve(report: Callable[[], str], period: float,
           seconds: Optional[float] = None) -> None:
    """Print ``report()`` every ``period`` seconds until interrupted, or
    until ``seconds`` have passed."""
    end = None if seconds is None else time.monotonic() + seconds
    try:
        while end is None or time.monotonic() < end:
            time.sleep(period if end is None else max(0.0, min(period, end - time.monotonic())))
            print(report(), flush=True)
    except KeyboardInterrupt:
        pass


def launch_sde_control(cfg: Dict[str, Any], device=None, seconds: Optional[float] = None,
                       repl: bool = False):
    """Start the MPC engine node (reference sde_control main,
    ``sde_control.py:750-769``); its constructor builds (or reuses) and
    warms every kernel before it serves. ``repl``: the mission REPL on
    stdin in place of the telemetry reports, until EOF or ``exit``."""
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode

    base = config_dir(cfg)
    traj = os.path.join(base, cfg["traj_ctrl"])
    sp = os.path.join(base, cfg["sp_ctrl"])
    print(f"[launch] building engine: traj={traj} sp={sp}", flush=True)
    log_file = cfg.get("log_file")
    logf = None

    def report() -> str:
        line = node.last_record.to_json()
        if logf:
            logf.write(line + "\n")
            logf.flush()
        return f"[telemetry] {line}"

    node = SDEControlNode(traj, sp, seed=int(cfg.get("seed", 0)), device=device)
    node.start()
    # the node runs from here on: a SIGTERM from now on must still stop it
    try:
        addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
        node.serve_mavlink(addr)
        svc_addr = cfg.get("addr_services", "127.0.0.1:14997")
        node.serve_services(svc_addr)
        print(f"[launch] engine ({node.ctrl.device}) serving MPC_FULL_STATE on udp:{addr}, "
              f"services on udp:{svc_addr}; mailbox {node.mailbox_kind}", flush=True)
        print("[launch] READY", flush=True)
        if repl:
            _mission_repl(node)
            return node
        logf = open(log_file, "a") if log_file else None
        _serve(report, float(cfg.get("mpc_report_dt", 0.2)), seconds)
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
        if logf:
            logf.close()
        print(f"[launch] engine stopped: {len(node.solve_steps)} plans published; kernel "
              f"launches {json.dumps(kernel_launches())}", flush=True)
    return node


def kernel_launches() -> Dict[str, int]:
    """Launches of each kernel in this process so far (every wrapper counts
    where it launches; the plain CPU versions count nothing)."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    return {"apg_solve": AK.apg_solve_kernel.launches,
            "value_batch": CO.value_batch_kernel.launches,
            "value_and_grad": CO.value_and_grad_kernel.launches,
            "trajectory": CO.trajectory_kernel.launches}


def _mission_repl(node) -> None:
    """The operator REPL on ``node`` (the original's ``:65-83``): engine
    verbs only, over a vehicle that reports itself in OFFBOARD at the
    origin and accepts no firmware parameters."""
    import numpy as np

    from sde4mbrl_px4_tpu_torch.cli.mission import MissionControl, VehicleBase, repl

    class _NullVehicle(VehicleBase):
        armed = False
        flight_mode = "OFFBOARD"

        def arm(self, value):
            pass

        def set_flight_mode(self, mode):
            pass

        def push_setpoint(self, pos, yaw):
            pass

        def position(self):
            return np.zeros(3)

        def yaw(self):
            return 0.0

        def mpc_status(self):
            return 0

    ctl = MissionControl(_NullVehicle(), engine=node, auto_spin=True)
    try:
        repl(ctl)
    finally:
        ctl.stop()


def launch_router(cfg: Dict[str, Any], seconds: Optional[float] = None):
    """Start the MAVLink fan-out router (the reference's ``px4_sitl.launch``
    + ``sitl_route_mavlink.sh`` transport bring-up; the original's
    ``:155-200``): a conf in the mavlink-router dialect defines the
    endpoints and their filters. Returns the router, stopped."""
    from sde4mbrl_px4_tpu_torch.io.router import (
        NativeRouter, Router, native_router_supports, parse_conf, parse_general)

    conf = cfg["conf"]
    if not os.path.isabs(conf):
        cand = [os.path.abspath(conf), os.path.normpath(os.path.join(cfg["_dir"], conf))]
        conf = next((c for c in cand if os.path.isfile(c)), cand[0])
    with open(conf) as f:
        text = f.read()
    endpoints = parse_conf(text)
    general = parse_general(text)          # [General] Log / LogMode
    native = cfg.get("native", True) and native_router_supports(endpoints, general)
    router = (NativeRouter if native else Router)(endpoints, log_dir=general.log_dir,
                                                  log_mode=general.log_mode)
    router.start()
    try:
        print(f"[launch] router ({'native C++' if native else 'python'}) fanning out "
              f"{len(endpoints)} endpoints ({', '.join(e.name for e in endpoints)}) from {conf}"
              + (f"; flight log -> {general.log_dir} ({general.log_mode})"
                 if general.log_dir else ""), flush=True)
        print("[launch] READY", flush=True)
        _serve(lambda: f"[router] frames in per endpoint {router.stats}", 1.0, seconds)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    return router


def launch_fcu_sim(cfg: Dict[str, Any], seconds: Optional[float] = None):
    """Start the SITL plant node (the reference's ``px4_sitl.launch``
    bring-up: a simulated FCU streaming MPC_FULL_STATE and consuming
    MPC_MOTORS_CMD). The plant runs on the host CPU."""
    import numpy as np

    from sde4mbrl_px4_tpu_torch.sim.sitl import fcu_sim_from_config

    def report() -> str:
        return (f"[fcu_sim] t={node.fcu.plant.t:7.2f}s "
                f"pos_ned={np.round(node.fcu.plant.x[:3], 3).tolist()} "
                f"status={node.fcu.status}")

    node = fcu_sim_from_config(cfg)
    # the node streams as soon as its plant thread runs, which may be before
    # start() returns: a SIGTERM from then on (a client that has read its
    # first frame) must still stop it
    try:
        node.start()
        print(f"[launch] fcu_sim ({cfg.get('vehicle', 'iris')}) streaming "
              f"MPC_FULL_STATE to udp:{node.addr} at "
              f"{1.0 / node.fcu.state_dt:.0f} Hz", flush=True)
        print("[launch] READY", flush=True)
        _serve(report, 1.0, seconds)
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
    return node


def launch_geometric(cfg: Dict[str, Any], seconds: Optional[float] = None) -> int:
    """Start the native geometric controller on the MAVLink side-channel
    (the original's ``:104-153``): the launch file is its flat parameter
    file, ``trajectory_path`` (relative to the configs directory) its
    trajectory, sampled at the time since the first ``MPC_FULL_STATE`` (the
    original's since the node's start: a plant brought up later would
    engage mid-trajectory, far from its start). Returns the commands
    sent."""
    import tempfile

    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.baselines.geometric import (
        GeoParams, NativeGeometricController)
    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES
    from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP

    ctl = NativeGeometricController(GeoParams())
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        for k, v in cfg.items():
            if not k.startswith("_") and k not in ("node", "trajectory_path"):
                f.write(f"{k}: {v}\n")
    try:
        ctl.load_params_file(f.name)
    finally:
        os.unlink(f.name)
    traj = cfg.get("trajectory_path")
    if traj:
        if not os.path.isabs(traj):
            traj = os.path.join(os.path.dirname(cfg["_dir"]), traj)
        if not ctl.load_trajectory(traj):
            raise FileNotFoundError(f"geometric_controller: cannot load trajectory {traj}")
    addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
    link = MavlinkUDP(addr, mode="udpin")
    sent, t0 = 0, None
    end = None if seconds is None else time.monotonic() + seconds
    try:
        print(f"[launch] geometric controller on udp:{addr}", flush=True)
        print("[launch] READY", flush=True)
        while end is None or time.monotonic() < end:
            msg = link.recv_match(type="MPC_FULL_STATE", timeout=0.1)
            if msg is None:
                continue
            t0 = time.monotonic() if t0 is None else t0
            sp = ctl.sample_trajectory(time.monotonic() - t0)
            if sp is None:
                continue
            pos, vel, acc, yaw = sp
            x_enu = ned2enu(torch.as_tensor(np.asarray(msg.state, np.float32))).numpy()
            cmd, _ = ctl.update(x_enu.astype(np.float64), pos, vel, acc, yaw)
            # thrust + FRD body rates out (FLU -> FRD flips y and z)
            tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
            link.send_motors_cmd(int(time.time() * 1e6), np.zeros(6, np.float32), tr,
                                 CONTROL_STATES["pos"], 0)
            sent += 1
    except KeyboardInterrupt:
        pass
    finally:
        link.close()
        print(f"[geometric] sent {sent} MPC_MOTORS_CMD frames", flush=True)
    return sent


def launch_from_file(path: str, repl: bool = False, device=None,
                     seconds: Optional[float] = None):
    cfg = _load(path)
    node_type = cfg.get("node", "sde_control")
    if repl and node_type != "sde_control":
        raise ValueError(f"--repl attaches to the engine node (sde_control), not {node_type!r}")
    if node_type == "sde_control":
        return launch_sde_control(cfg, device=device, seconds=seconds, repl=repl)
    if node_type == "fcu_sim":
        return launch_fcu_sim(cfg, seconds=seconds)
    if node_type == "geometric_controller":
        return launch_geometric(cfg, seconds=seconds)
    if node_type == "router":
        return launch_router(cfg, seconds=seconds)
    raise ValueError(f"unknown node type {node_type!r}")


def _sigterm(*_):
    raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.launch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("launch_file")
    ap.add_argument("--repl", action="store_true",
                    help="attach the mission REPL on stdin to the engine node")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    ap.add_argument("--seconds", type=float, default=None,
                    help="stop after this many seconds of serving (default: run until "
                         "interrupted)")
    args = ap.parse_args(argv)
    signal.signal(signal.SIGTERM, _sigterm)   # stop cleanly, as on Ctrl-C
    launch_from_file(args.launch_file, repl=args.repl, device="cpu" if args.cpu else None,
                     seconds=args.seconds)


if __name__ == "__main__":
    main()

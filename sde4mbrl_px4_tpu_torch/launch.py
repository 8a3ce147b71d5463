"""Node launcher (L7) — the roslaunch tier, ROS-free.

PyTorch counterpart of ``sde4mbrl_px4_tpu/launch.py`` (``:36-66``,
``:201-227``). A launch YAML names the node type and its parameters::

    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_px4_sitl.yaml &
    python -m sde4mbrl_px4_tpu_torch.launch configs/launch/iris_sdectrl.yaml

- ``node: sde_control`` — the async MPC engine (``io/engine_runtime.py``)
  on the card (``--cpu``: on the CPU), serving the MAVLink UDP side-channel
  and the JSON service channel;
- ``node: fcu_sim`` — the SITL plant (``sim/sitl.py``; the plant runs on
  the host CPU).

Each node prints ``[launch] READY`` once it serves, then runs until
interrupted (SIGINT or SIGTERM) and stops its threads. Start a second node
as a fresh process (``subprocess``), never by forking one that has
initialised CUDA. ``node: router``, ``node: geometric_controller`` and
``--repl`` raise ``NotImplementedError`` naming their ROADMAP item; there
is no ``--coordinator`` (multi-host is ``torch.distributed``, ROADMAP
'Batched and fleet').
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Callable, Dict

import yaml

__all__ = ["launch_from_file", "main", "NOT_PORTED"]

# node types (and --repl) the port does not run yet, and the ROADMAP.md §1
# item that brings each
NOT_PORTED = {"router": "Router launch node",
              "geometric_controller": "Baselines",
              "repl": "Mission CLI and --repl"}


def _load(path: str) -> Dict[str, Any]:
    with open(os.path.expanduser(path)) as f:
        cfg = yaml.safe_load(f)
    cfg["_dir"] = os.path.dirname(os.path.abspath(path))
    return cfg


def _refuse(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sde4mbrl_px4_tpu_torch yet; ROADMAP.md §1 "
        f"'{NOT_PORTED[key]}' brings it")


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


def _serve(report: Callable[[], str], period: float) -> None:
    """Print ``report()`` every ``period`` seconds until interrupted."""
    try:
        while True:
            time.sleep(period)
            print(report(), flush=True)
    except KeyboardInterrupt:
        pass


def launch_sde_control(cfg: Dict[str, Any], device=None):
    """Start the MPC engine node (reference sde_control main,
    ``sde_control.py:750-769``); its constructor builds (or reuses) and
    warms every kernel before it serves."""
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode

    base = config_dir(cfg)
    traj = os.path.join(base, cfg["traj_ctrl"])
    sp = os.path.join(base, cfg["sp_ctrl"])
    print(f"[launch] building engine: traj={traj} sp={sp}", flush=True)
    node = SDEControlNode(traj, sp, seed=int(cfg.get("seed", 0)), device=device)
    node.start()
    addr = cfg.get("addr_mavlink_state_msg", "127.0.0.1:14998")
    node.serve_mavlink(addr)
    svc_addr = cfg.get("addr_services", "127.0.0.1:14997")
    node.serve_services(svc_addr)
    print(f"[launch] engine ({node.ctrl.device}) serving MPC_FULL_STATE on udp:{addr}, "
          f"services on udp:{svc_addr}; mailbox {node.mailbox_kind}", flush=True)
    print("[launch] READY", flush=True)

    log_file = cfg.get("log_file")
    logf = open(log_file, "a") if log_file else None

    def report() -> str:
        line = node.last_record.to_json()
        if logf:
            logf.write(line + "\n")
            logf.flush()
        return f"[telemetry] {line}"

    try:
        _serve(report, float(cfg.get("mpc_report_dt", 0.2)))
    finally:
        node.stop()
        if logf:
            logf.close()
    return node


def launch_fcu_sim(cfg: Dict[str, Any]):
    """Start the SITL plant node (the reference's ``px4_sitl.launch``
    bring-up: a simulated FCU streaming MPC_FULL_STATE and consuming
    MPC_MOTORS_CMD). The plant runs on the host CPU."""
    import numpy as np

    from sde4mbrl_px4_tpu_torch.sim.sitl import fcu_sim_from_config

    node = fcu_sim_from_config(cfg)
    node.start()
    print(f"[launch] fcu_sim ({cfg.get('vehicle', 'iris')}) streaming "
          f"MPC_FULL_STATE to udp:{node.addr} at "
          f"{1.0 / node.fcu.state_dt:.0f} Hz", flush=True)
    print("[launch] READY", flush=True)

    def report() -> str:
        return (f"[fcu_sim] t={node.fcu.plant.t:7.2f}s "
                f"pos_ned={np.round(node.fcu.plant.x[:3], 3).tolist()} "
                f"status={node.fcu.status}")

    try:
        _serve(report, 1.0)
    finally:
        node.stop()
    return node


def launch_from_file(path: str, repl: bool = False, device=None):
    cfg = _load(path)
    node_type = cfg.get("node", "sde_control")
    if repl:
        raise _refuse("the mission REPL (--repl)", "repl")
    if node_type == "sde_control":
        return launch_sde_control(cfg, device=device)
    if node_type == "fcu_sim":
        return launch_fcu_sim(cfg)
    if node_type in NOT_PORTED:
        raise _refuse(f"node: {node_type}", node_type)
    raise ValueError(f"unknown node type {node_type!r}")


def _sigterm(*_):
    raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.launch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("launch_file")
    ap.add_argument("--repl", action="store_true",
                    help="attach the mission REPL (not ported)")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    args = ap.parse_args(argv)
    signal.signal(signal.SIGTERM, _sigterm)   # stop cleanly, as on Ctrl-C
    launch_from_file(args.launch_file, repl=args.repl, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()

"""Closed loop: the port's async MPC engine against a simulated FCU over UDP
MAVLink.

The port's counterpart of ``examples/closed_loop_sim.py``, with the same
options and the same PASS gate (mean tracking error < 0.35 m over
t_traj > 3 s and FCU status ``MPC_ON``; runs of 30 s or more also hold the
timeout ticks to 2 % and the pickup index to 1)::

    FCUSim (plant + watchdog + blend)               SDEControlNode
      |  MPC_FULL_STATE (id 367)  --- UDP --->  ingress -> automata -> pick
      |  <--- UDP --- MPC_MOTORS_CMD (id 368)   solver thread (doorbell)

    python -m sde4mbrl_px4_tpu_torch.sim.closed_loop [--vehicle hexa] [--cpu]

The engine runs on the card (``--cpu``: the plain versions on the CPU); the
plant runs on the host CPU. Besides the reference's numbers it prints the
solve time p50 and iterations of the published plans, the ingress pick's
latency p50 and p99, and which mailbox and MAVLink codec ran. ``--traj-config``
and ``--pos-config`` replace the vehicle's shipped configs.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sde4mbrl_px4_tpu_torch.sim.closed_loop",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    ap.add_argument("--port", type=int, default=0,
                    help="the engine's MAVLink UDP port (0: a free one)")
    ap.add_argument("--state-rate", type=float, default=50.0)
    ap.add_argument("--time-scale", type=float, default=1.0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--log", default=None, help="write a flight log (not ported)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="blocking solver dispatch (pipeline off)")
    ap.add_argument("--solver", default="apg", choices=("apg", "mppi", "policy"))
    ap.add_argument("--particles", type=int, default=0,
                    help="fly num_particles antithetic Monte-Carlo paths per "
                         "trajectory solve")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="inject apg_mpc.deadline_ms (the iteration budget)")
    ap.add_argument("--vehicle", default="iris", choices=("iris", "hexa"))
    ap.add_argument("--plant", default="sde", choices=("sde", "rigid"),
                    help="sde: the learned model as plant; rigid: the "
                         "independent Newton-Euler plant (sim/rigid_body.py)")
    ap.add_argument("--mass-scale", type=float, default=1.0,
                    help="with --plant rigid: payload-style mass/inertia scale")
    ap.add_argument("--wind", type=float, default=0.0,
                    help="with --plant rigid: constant lateral wind, m/s")
    ap.add_argument("--traj-config", default=None)
    ap.add_argument("--pos-config", default=None)
    return ap


def _configs(args, tmpdir: str):
    """The (traj, pos) config paths, with the solver, deadline and particle
    count injected into copies where asked (as the example does)."""
    import yaml

    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    traj_cfg = args.traj_config or os.path.join(_ROOT, f"configs/{args.vehicle}_traj_mpc.yaml")
    pos_cfg = args.pos_config or os.path.join(_ROOT, f"configs/{args.vehicle}_posctrl_mpc.yaml")
    if args.solver == "apg" and not args.deadline_ms and not args.particles:
        return traj_cfg, pos_cfg
    out = []
    for src in (traj_cfg, pos_cfg):
        c = load_yaml_config(src)
        c["solver"] = args.solver
        if args.deadline_ms:
            c.setdefault("apg_mpc", {})["deadline_ms"] = args.deadline_ms
        if args.particles and src == traj_cfg:
            c["num_particles"] = args.particles
            c["antithetic"] = True
        dst = os.path.join(tmpdir, ("traj_" if src == traj_cfg else "pos_")
                           + os.path.basename(src))
        with open(dst, "w") as f:
            yaml.safe_dump({k: v for k, v in c.items() if not k.startswith("_")}, f)
        out.append(dst)
    return tuple(out)


def _plant(args):
    if args.plant == "rigid":
        from sde4mbrl_px4_tpu_torch.sim.rigid_body import RigidBodyParams, RigidBodyPlant

        rb = RigidBodyParams.nominal(args.vehicle).perturbed(
            mass_scale=args.mass_scale,
            wind=[args.wind, args.wind * 0.6, 0.0] if args.wind else None)
        return RigidBodyPlant(rb, sim_dt=0.002)
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import vehicle_from_name
    from sde4mbrl_px4_tpu_torch.sim.plant import SDEPlant

    params, _ = load_params(os.path.join(_ROOT, f"configs/models/{args.vehicle}_sde.pkl"))
    return SDEPlant(NeuralSDE.for_vehicle(vehicle_from_name(args.vehicle)), params,
                    sim_dt=0.005)


def run(argv: Optional[list] = None) -> dict:
    """Fly one closed loop; returns its numbers (``ok`` is the PASS gate)."""
    args = parser().parse_args(argv)
    if args.solver == "policy":
        raise NotImplementedError(
            "--solver policy is not ported to sde4mbrl_px4_tpu_torch yet; "
            "ROADMAP.md §1 'Policy solver family' brings it")
    if args.log:
        raise NotImplementedError(
            "--log (io/flight_log.py, with io/ulog.py and io/router.py) is not "
            "ported to sde4mbrl_px4_tpu_torch yet; ROADMAP.md §1 'Flight log' "
            "brings it")

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.core.types import CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import SDEControlNode
    from sde4mbrl_px4_tpu_torch.io.mavlink import MavlinkUDP, load_native
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim

    # Simulation clock: the engine's automata and command stamps follow the
    # PLANT's clock, as the reference follows the FCU time base.
    class SimClock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = SimClock()
    tmp = tempfile.TemporaryDirectory(prefix="closed_loop_cfg_")
    node = link = None
    stop = threading.Event()
    rx = None
    try:
        traj_cfg, pos_cfg = _configs(args, tmp.name)
        print(f"== building the engine (two MPC solvers, {args.solver}, "
              f"{'cpu' if args.cpu else 'cuda'}) ==", flush=True)
        t_build = time.perf_counter()
        node = SDEControlNode(traj_cfg, pos_cfg, seed=0, now_fn=clock,
                              pipeline=not args.no_pipeline,
                              device="cpu" if args.cpu else None)
        build_s = time.perf_counter() - t_build
        node.start()
        node.serve_mavlink(f"127.0.0.1:{args.port}")
        port = node.mav.sock.getsockname()[1]

        plant = _plant(args)
        sft = node.ctrl.traj.state_from_traj_host
        # state_from_traj is ENU at the API boundary; the plant runs NED.
        start = enu2ned(sft(0.0)).numpy().astype(np.float32)
        start[3:6] = 0.0     # custom full-speed-start CSVs: start at rest
        plant.reset(start)
        fcu = FCUSim(plant, state_rate_hz=args.state_rate)
        link = MavlinkUDP(f"127.0.0.1:{port}", mode="udpout")

        def cmd_rx_loop():
            while not stop.is_set():
                msg = link.recv_match(type="MPC_MOTORS_CMD", timeout=0.05)
                if msg is not None:
                    fcu.push_cmd(msg.motor_val_des, msg.thrust_and_angrate_des,
                                 msg.mpc_on, msg.weight_motors)

        rx = threading.Thread(target=cmd_rx_loop, daemon=True, name="fcu-rx")
        rx.start()

        # Mission script: init -> idle -> start trajectory (reference CLI verbs
        # controller_init / controller_idle / weight_motors / controller_on).
        if not node.initialize_mpc():
            raise RuntimeError("initialize_mpc refused")
        node.set_mode(CTRL_TRAJ_IDLE)
        node.set_mode(0, weight_motors=100)   # motor passthrough (blend knob)

        state_dt = 1.0 / args.state_rate
        n_steps = int(args.seconds / state_dt)
        errs = []
        t_started = None
        watchdog_trips = timeout_ticks = tracked_ticks = 0
        prev_status = fcu.status
        max_pickup_idx = 0
        solves0 = len(node.solve_seconds)
        wall0 = time.perf_counter()
        for k in range(n_steps):
            clock.t = plant.t
            x, t_usec = fcu.full_state_msg()
            link.send_full_state(int(t_usec), x)
            time.sleep(state_dt * args.time_scale)   # pace the sim ~ real time
            fcu.run_control_period(state_dt)
            if args.verbose and k % 10 == 0:
                c = fcu.last_cmd
                print(f"t={plant.t:5.2f} pos={plant.x[:3].round(2)} "
                      f"cmd={'None' if c is None else np.round(c[0][:4], 3)} "
                      f"mpc_on={'-' if c is None else c[2]} idx={node._last_index} "
                      f"status={fcu.status}", flush=True)
            if k == int(1.0 / state_dt):   # after 1 s of idle, start the trajectory
                node.set_mode(CTRL_TRAJ_ACTIVE)
                t_started = time.time()
            running = t_started is not None and node.ctrl.automata.run_trajectory
            if running:
                t_traj = node.ctrl.automata.trajec_time
                # steady-state window: the shipped CSVs ramp from rest over
                # 1.5 s and the transient settles by ~t_traj 2.7
                if t_traj > 3.0:
                    ref = enu2ned(sft(float(t_traj))).numpy()
                    errs.append(float(np.linalg.norm(plant.x[:3] - ref[:3])))
                    max_pickup_idx = max(max_pickup_idx, int(node._last_index))
            if prev_status == FCUSim.MPC_ON and fcu.status == FCUSim.MPC_TIMEOUT:
                watchdog_trips += 1
            if running:
                tracked_ticks += 1
                timeout_ticks += int(fcu.status == FCUSim.MPC_TIMEOUT)
            prev_status = fcu.status
        wall_s = time.perf_counter() - wall0
    finally:
        stop.set()
        if rx is not None:
            rx.join(timeout=1.0)
        if node is not None:
            node.stop()
        if link is not None:
            link.close()
        tmp.cleanup()

    rec = node.last_record
    errs = np.asarray(errs) if errs else np.asarray([np.inf])
    to_frac = timeout_ticks / max(tracked_ticks, 1)
    solves = list(node.solve_seconds)[solves0:]
    steps = list(node.solve_steps)[solves0:]
    picks = list(node.pick_seconds)
    ok = bool(errs.mean() < 0.35 and fcu.status == FCUSim.MPC_ON)
    if args.seconds >= 30:
        ok = ok and to_frac <= 0.02 and max_pickup_idx <= 1
    res = {
        "ok": ok, "vehicle": args.vehicle, "solver": args.solver,
        "particles": args.particles, "device": "cpu" if args.cpu else "cuda",
        "plant": args.plant, "pipeline": not args.no_pipeline,
        "seconds": args.seconds, "time_scale": args.time_scale, "wall_s": wall_s,
        "build_s": build_s, "err_mean_m": float(errs.mean()),
        "err_max_m": float(errs.max()), "err_ticks": int(len(errs)),
        "fcu_status": int(fcu.status), "watchdog_trips": watchdog_trips,
        "timeout_ticks": timeout_ticks, "tracked_ticks": tracked_ticks,
        "timeout_frac": to_frac, "max_pickup_idx": max_pickup_idx,
        "overruns": node.overruns.count, "solves": len(solves),
        "solve_ms_p50": statistics.median(solves) * 1e3 if solves else float("nan"),
        "solve_ms_max": max(solves) * 1e3 if solves else float("nan"),
        "iterations_p50": statistics.median(steps) if steps else float("nan"),
        "first_iterations": steps[:3],
        "pick_ms_p50": float(np.percentile(picks, 50)) * 1e3,
        "pick_ms_p99": float(np.percentile(picks, 99)) * 1e3,
        "picks": len(picks), "mailbox": node.mailbox_kind,
        "codec": "python" + (" (native codec built, not used by MavlinkUDP)"
                             if load_native() is not None else ""),
        "last_state": rec.ctrl_state, "last_steps": rec.num_steps,
    }
    print(f"engine status: steps={rec.num_steps} solve={rec.solve_time * 1e3:.1f}ms "
          f"state={rec.ctrl_state} idx={rec.mpc_indx} fcu_status={fcu.status}")
    print(f"tracking error over {len(errs)} ticks: "
          f"mean={errs.mean():.3f}m max={errs.max():.3f}m; "
          f"watchdog trips={watchdog_trips} "
          f"(timeout ticks {timeout_ticks}/{tracked_ticks} = {to_frac:.1%}), "
          f"max pickup idx={max_pickup_idx}")
    print(f"solves {res['solves']}: p50 {res['solve_ms_p50']:.3f} ms at "
          f"{res['iterations_p50']} iterations (first {res['first_iterations']}); "
          f"ingress pick p50 {res['pick_ms_p50']:.4f} ms p99 {res['pick_ms_p99']:.4f} ms "
          f"over {res['picks']}; mailbox {res['mailbox']}, codec {res['codec']}")
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return res


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

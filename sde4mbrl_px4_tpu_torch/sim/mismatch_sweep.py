"""Model-mismatch robustness sweep: the MPC and the geometric baseline on an
independent rigid-body plant.

The port's counterpart of ``examples/mismatch_sweep.py``, with its cells,
its options and its gate::

    python -m sde4mbrl_px4_tpu_torch.sim.mismatch_sweep [--vehicle hexa] [--seconds 4]
        [--iters 60] [--out build/mismatch/MISMATCH.json] [--cpu]

The flagship posctrl MPC (``make_mpc_from_config`` at ``--iters`` APG
iterations: on the card one launch of the whole-solve kernel a period), the
same MPC with the integral reference shaping of ``engine/offset.py``
(``DisturbanceEstimator``, run 2.5x longer and measured over its steady
window) and the native C++ geometric controller
(``baselines/geometric.py``) each fly the port's Newton-Euler plant
(``sim/rigid_body.py``, which the SDE model does not share) through the
FCU shim (``sim/plant.py::FCUSim``; the MPC at ``weight_motors`` 100, the
geometric controller's thrust and rates at 0) in 11 physically perturbed
cells: mass x0.8 / x1.2, drag x0.5 / x1.5, motor lag 5 / 10 / 20 ms,
thrust coefficient x0.9, a ~4 m/s wind and a combined worst case. The
workload is a 0.5 m offset recovery and hold; the metric the
steady-window tracking error. Gate: the nominal MPC's mean below 0.05 m and
every cell's MPC bounded below 1.5 m.

The JSON goes to ``--out`` (default ``build/mismatch/MISMATCH.json``, or
``MISMATCH_<vehicle>.json``, beside the build's other outputs); the JAX
package's committed ``artifacts/MISMATCH*.json`` are never written. Without
``csrc/libmpc_native.so`` (``make -C csrc``) the sweep flies the MPC only
and says so. ``--cpu`` runs the plain solves on the CPU (slow: seconds a
solve at 60 iterations).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

__all__ = ["CELLS", "fly_geometric", "fly_mpc", "run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = [
    ("nominal", {}),
    ("mass_x0.8", dict(mass_scale=0.8)),
    ("mass_x1.2", dict(mass_scale=1.2)),
    ("drag_x0.5", dict(drag_scale=0.5)),
    ("drag_x1.5", dict(drag_scale=1.5)),
    ("lag_5ms", dict(motor_tau=0.005)),
    ("lag_10ms", dict(motor_tau=0.010)),
    ("lag_20ms", dict(motor_tau=0.020)),
    ("ct_x0.9", dict(ct_scale=0.9)),
    ("wind_4ms", dict(wind=[3.0, 2.5, 0.0])),   # ~4 m/s lateral wind
    ("worst_combo", dict(mass_scale=1.2, drag_scale=1.5, motor_tau=0.020)),
]
NOMINAL_LT_M, BOUNDED_LT_M = 0.05, 1.5      # the gate (original :204-207)


def _start() -> np.ndarray:
    """The 0.5 m offset start (NED x 0.5, z -0.3), level and at rest."""
    x0 = np.zeros(13)
    x0[6] = 1.0
    x0[0], x0[2] = 0.5, -0.3
    return x0


def fly_mpc(mpc, plant, seconds: float, adapt: bool = False,
            settle: Optional[float] = None):
    """The MPC closed loop through ``FCUSim`` at ``weight_motors`` 100
    (original ``:53-96``). ``mpc`` is ``(cfg, reset_fn, mpc_fn)`` of a
    position config; ``adapt`` arms the integral reference shaping;
    ``settle`` starts the measurement window (default ``seconds / 2``).
    Returns the window's (mean, max) position error [m]; one host read of
    the plan a period (the plant steps on the host)."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
    from sde4mbrl_px4_tpu_torch.engine.offset import DisturbanceEstimator
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim

    cfg, reset_fn, mpc_fn = mpc
    dt = float(cfg["_time_steps"][0])
    plant.reset(_start())
    fcu = FCUSim(plant)
    tgt_ned = hover_state().numpy()
    tgt_enu = ned2enu(hover_state()).numpy()
    tgt = torch.from_numpy(tgt_enu)
    est = DisturbanceEstimator(gain=0.6, limit=1.0, dt=dt) if adapt else None
    st = reset_fn(torch.as_tensor(plant.x, dtype=torch.float32), None, tgt)
    errs = []
    for k in range(int(seconds / dt)):
        x, _ = fcu.full_state_msg()
        if est is not None:
            tgt = torch.from_numpy(est.update(x, tgt_enu))
        u, st, _, xe = mpc_fn(torch.as_tensor(x, dtype=torch.float32), None, st, 0.0, tgt)
        u_host, xe1 = u[0].cpu().numpy(), xe[1].cpu().numpy()
        u6 = np.zeros(6, np.float32)
        u6[: u_host.shape[0]] = u_host
        w4 = np.array([float(u_host.mean()), *xe1[10:13]], np.float32)
        fcu.push_cmd(u6, w4, CONTROL_STATES["pos"], 100)
        fcu.run_control_period(dt)
        if k * dt >= (seconds / 2 if settle is None else settle):
            errs.append(np.linalg.norm(plant.x[:3] - tgt_ned[:3]))
    return float(np.mean(errs)), float(np.max(errs))


def fly_geometric(ctl, plant, seconds: float, dt: float = 0.02):
    """The geometric baseline through ``FCUSim`` at ``weight_motors`` 0:
    its thrust and ENU/FLU body rates, executed by the FCU's rate loop as
    NED/FRD (original ``:99-132``). Returns (mean, max) [m]."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
    from sde4mbrl_px4_tpu_torch.sim.plant import FCUSim

    plant.reset(_start())
    fcu = FCUSim(plant)
    tgt_ned = hover_state().numpy()
    # the controller works in ENU/FLU: the hover target's NED identity
    # attitude is ENU yaw pi/2 (the frame swap), the yaw to hold
    qe = ned2enu(hover_state()).numpy()[6:10]
    tgt_yaw = float(np.arctan2(2 * (qe[0] * qe[3] + qe[1] * qe[2]),
                               1 - 2 * (qe[2] ** 2 + qe[3] ** 2)))
    errs = []
    for k in range(int(seconds / dt)):
        x, _ = fcu.full_state_msg()
        x_enu = ned2enu(torch.as_tensor(np.asarray(x, np.float32))).numpy().astype(np.float64)
        cmd, _q = ctl.update(x_enu, np.zeros(3), np.zeros(3), np.zeros(3), tgt_yaw)
        tr = np.array([cmd[3], cmd[0], -cmd[1], -cmd[2]], np.float32)
        fcu.push_cmd(np.zeros(6, np.float32), tr, CONTROL_STATES["pos"], 0)
        fcu.run_control_period(dt)
        if k * dt >= seconds / 2:
            errs.append(np.linalg.norm(plant.x[:3] - tgt_ned[:3]))
    return float(np.mean(errs)), float(np.max(errs))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.mismatch_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    ap.add_argument("--vehicle", choices=("iris", "hexa"), default="iris")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=60,
                    help="APG iteration budget (full 200 changes nothing at hover)")
    ap.add_argument("--cells", default=None,
                    help="comma-separated cell names to fly (default: all 11)")
    ap.add_argument("--out", default=None)
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Fly the sweep; returns the JSON record (``gate.pass`` is the gate,
    ``geometric`` whether the native baseline flew)."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.baselines.geometric import (
        GeoParams, NativeGeometricController)
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.sim.rigid_body import RigidBodyParams, RigidBodyPlant

    cfg = load_yaml_config(os.path.join(_ROOT, f"configs/{args.vehicle}_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = args.iters
    cfg, (reset_fn, mpc_fn), _, bundle = make_mpc_from_config(
        cfg, device="cpu" if args.cpu else None)
    dev = bundle.device
    mpc = (cfg, reset_fn, mpc_fn)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}; "
          f"{args.vehicle} posctrl MPC at {args.iters} APG iterations", flush=True)

    nominal = RigidBodyParams.nominal(args.vehicle)
    try:
        # the thrust constant from the plant's own nominal hover calibration
        geo = NativeGeometricController(GeoParams(
            norm_thrust_const=nominal.hover_u / 9.81, norm_thrust_offset=0.0,
            kp=(2.0, 2.0, 4.0), kv=(2.0, 2.0, 3.0)))
    except RuntimeError as e:
        print(f"geometric baseline unavailable ({e}); MPC-only sweep", flush=True)
        geo = None

    cells = CELLS
    if args.cells:
        keep = args.cells.split(",")
        cells = [c for c in CELLS if c[0] in keep]
    rows = []
    print(f"{'cell':14s} {'MPC mean/max [m]':>20s} "
          f"{'MPC+adapt mean [m]':>19s} {'geometric mean/max [m]':>24s}", flush=True)
    with torch.no_grad():
        for name, pert in cells:
            p = nominal.perturbed(**pert) if pert else nominal
            m_mean, m_max = fly_mpc(mpc, RigidBodyPlant(p), args.seconds)
            # the integrator needs its convergence time: a longer run,
            # measured over its steady window
            a_mean, a_max = fly_mpc(mpc, RigidBodyPlant(p), 2.5 * args.seconds,
                                    adapt=True, settle=2.0 * args.seconds)
            row = {"cell": name, "perturbation": pert,
                   "mpc_mean_m": round(m_mean, 4), "mpc_max_m": round(m_max, 4),
                   "mpc_adapt_mean_m": round(a_mean, 4), "mpc_adapt_max_m": round(a_max, 4)}
            line = f"{name:14s} {m_mean:9.3f}/{m_max:6.3f} {a_mean:18.3f}"
            if geo is not None:
                g_mean, g_max = fly_geometric(geo, RigidBodyPlant(p), args.seconds)
                row["geo_mean_m"], row["geo_max_m"] = round(g_mean, 4), round(g_max, 4)
                line += f" {g_mean:14.3f}/{g_max:6.3f}"
            print(line, flush=True)
            rows.append(row)

    by = {r["cell"]: r for r in rows}
    ok = (("nominal" not in by or by["nominal"]["mpc_mean_m"] < NOMINAL_LT_M)
          and all(np.isfinite(r["mpc_max_m"]) and r["mpc_max_m"] < BOUNDED_LT_M
                  for r in rows))
    out = args.out or os.path.join(
        _ROOT, "build", "mismatch",
        "MISMATCH.json" if args.vehicle == "iris" else f"MISMATCH_{args.vehicle}.json")
    record = {
        "what": ("closed-loop steady-state tracking error vs physical perturbation of the "
                 "INDEPENDENT rigid-body plant (sim/rigid_body.py); 0.5 m offset recovery + "
                 f"hold, {args.vehicle} posctrl MPC (weight_motors=100) vs C++ geometric "
                 "baseline (thrust+rates via FCU rate loop)"),
        "plant": "Newton-Euler + first-order motor lag + lin/quad drag, RK4, parameters "
                 "independent of the SDE checkpoint",
        "device": "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "workload_seconds": args.seconds, "apg_iters": args.iters, "cells": rows,
        # the MPC's control periods (solves) over the sweep, both variants
        "mpc_periods": len(rows) * sum(int(s / float(cfg["_time_steps"][0]))
                                       for s in (args.seconds, 2.5 * args.seconds)),
        "geometric": geo is not None,
        "gate": {"nominal_mpc_mean_lt_m": NOMINAL_LT_M,
                 "all_cells_bounded_lt_m": BOUNDED_LT_M, "pass": bool(ok)},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {out}")
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return record


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["gate"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

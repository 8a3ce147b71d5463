"""Closed-loop process-noise robustness: what the SDE in neural-SDE MPC buys.

The port's counterpart of ``examples/noise_robustness.py``, with its
options, defaults and PASS gate::

    python -m sde4mbrl_px4_tpu_torch.sim.noise_robustness [--seconds 12] [--seeds 3]
        [--particles 128] [--noise-scale 0.6] [--cpu]

A NOISY plant (``sim/plant.py::SDEPlant`` with ``process_noise``: the
checkpoint's model integrated with its Brownian term at 10 ms sub-steps,
its diffusion scaled to ``--noise-scale``, on the host CPU) holds a hover
7 cm above a hard altitude floor (NED z <= -1.2 m), which the solver sees
as a ``state_constr`` penalty on z. Three controllers fly the same task,
each against the same plant noise per seed (common random numbers):

1. mean-dynamics MPC (``num_particles: 1``, the reference flight config);
2. particle MPC (``--particles`` antithetic paths: the penalty sees the
   violation probability through the noisy rollouts);
3. risk-averse particle MPC (plus ``risk_lambda: 2``).

The solver's model carries the same diffusion scale as the plant. Each
tick solves from the plant's state (the previous solve's warm start and the
solver's own generator) and applies ``u[0]`` for one 50 ms period. Per
controller and seed it prints the tracking RMSE, the fraction of ticks
below the floor, the mean violation depth and ms per solve (the wall time
of the loop over its ticks, plant included), then each controller's mean
over the seeds. ``RESULT: PASS`` when the risk-averse controller's
violation fraction is at most the mean controller's and every reading is
finite (the example's gate). ``--cpu`` runs the plain solves on the CPU
(slow: use ``--particles 16 --seconds 2 --seeds 1``).
"""
from __future__ import annotations

import argparse
import copy
import math
import os
import sys
import time
from typing import Optional

import numpy as np

__all__ = ["FLOOR_Z", "HOVER_Z", "fly", "run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLOOR_Z = -1.2        # NED: altitude 1.2 m; a violation when z > FLOOR_Z
HOVER_Z = -1.27       # the hold, 0.07 m above the floor (the example's)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.noise_robustness",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--noise-scale", type=float, default=0.6,
                    help="plant and model diffusion magnitude (exp-scale)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="independent noise realizations per controller")
    return ap


def fly(cfg: dict, plant_params: dict, noise_scale: float, seconds: float, seed: int,
        label: str, device=None) -> tuple:
    """One closed loop (module docstring): solve, apply ``u[0]`` to the noisy
    plant for one control period, repeat. Returns ``(rmse, violation
    fraction, mean violation depth in m, ms per solve)``."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim.plant import SDEPlant

    cfg, (reset_fn, mpc_fn), _, b = make_mpc_from_config(copy.deepcopy(cfg), device=device)
    b.params["diffusion_log_scale"].fill_(math.log(noise_scale))
    dev = b.device
    dt = float(cfg["_time_steps"][0])
    n = int(seconds / dt)
    tgt = hover_state().numpy()
    tgt[2] = HOVER_Z                                    # NED: the plant's frame
    tgt_enu = ned2enu(torch.from_numpy(tgt)).to(dev)    # mpc_fn's xdes is ENU
    plant = SDEPlant(NeuralSDE.for_vehicle(iris_config(), "cpu"), plant_params, sim_dt=0.01,
                     process_noise=True, seed=seed)
    plant.reset(tgt)
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(plant.x).to(dev)
    with torch.no_grad():
        sol = mpc_fn(x, gen, reset_fn(x, gen, tgt_enu), 0.0, tgt_enu)
        sol.u_opt.cpu()
        zs, errs = [], []
        t0 = time.perf_counter()
        for _ in range(n):
            x = torch.from_numpy(np.asarray(plant.x, np.float32)).to(dev)
            sol = mpc_fn(x, gen, sol.opt_state, 0.0, tgt_enu)
            plant.step(sol.u_opt[0].cpu().numpy(), dt)
            zs.append(float(plant.x[2]))
            errs.append(float(np.linalg.norm(plant.x[:3] - tgt[:3])))
        wall = (time.perf_counter() - t0) / n
    zs = np.asarray(zs)
    viol = float((zs > FLOOR_Z).mean())
    depth = float(np.mean(np.maximum(zs - FLOOR_Z, 0.0)))
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    print(f"  {label:28s} rmse={rmse:.3f}m  floor violations={viol:6.1%}  "
          f"mean depth={depth * 100:.1f}cm  {wall * 1e3:6.1f} ms/solve", flush=True)
    return rmse, viol, depth, wall * 1e3


def run(argv: Optional[list] = None) -> dict:
    """Fly every controller over every seed; returns ``{"table": {label:
    (rmse, violations, depth, ms)}, "rows": {label: [...]}, "ok": ...}``."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params

    device = "cpu" if args.cpu else None
    base = load_yaml_config(os.path.join(_ROOT, "configs/iris_posctrl_mpc.yaml"))
    base["apg_mpc"]["max_iter"] = 60
    base["apg_mpc"]["max_no_improvement_iter"] = 60
    # the altitude floor as the solver sees it (state_constr penalty form)
    base["state_constr"] = {"state_id": [2], "state_bound": [[-5.0, float(FLOOR_Z)]],
                            "state_penalty": [300.0], "slack_scaling": [1.0]}
    params, _ = load_params(base["learned_model_params"])
    plant_params = dict(params, diffusion_log_scale=np.float32(np.log(args.noise_scale)))
    P = args.particles
    variants = [
        ("mean (particles=1)", {}),
        (f"particles={P} anti", {"num_particles": P, "antithetic": True}),
        (f"particles={P} risk l=2", {"num_particles": P, "antithetic": True,
                                     "cost_params": dict(base["cost_params"],
                                                         risk_lambda=2.0)}),
    ]
    name = "cpu" if args.cpu else (torch.cuda.get_device_name(0)
                                   if torch.cuda.is_available() else "no CUDA card")
    print(f"device: {name}; hover-hold {abs(HOVER_Z - FLOOR_Z):.2f} m above a floor, plant "
          f"noise scale {args.noise_scale}, {args.seconds:.0f} s x {args.seeds} seeds per "
          f"controller", flush=True)
    table, rows = {}, {}
    for label, mut in variants:
        cfg = dict(copy.deepcopy(base), **mut)
        rows[label] = [fly(cfg, plant_params, args.noise_scale, args.seconds, seed,
                           f"{label} s{seed}", device) for seed in range(args.seeds)]
        table[label] = tuple(float(v) for v in np.asarray(rows[label]).mean(axis=0))
        print(f"  {label:28s} == mean over {args.seeds} seeds: rmse={table[label][0]:.3f}m "
              f"violations={table[label][1]:.1%} depth={table[label][2] * 100:.1f}cm",
              flush=True)
    v_mean, v_risk = table[variants[0][0]][1], table[variants[2][0]][1]
    finite = all(np.isfinite(r).all() for r in rows.values())
    ok = bool(v_risk <= v_mean and finite)
    print(f"\nfloor-violation fraction: mean-MPC {v_mean:.1%} -> risk-averse particle MPC "
          f"{v_risk:.1%}")
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return {"table": table, "rows": rows, "finite": finite, "ok": ok}


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

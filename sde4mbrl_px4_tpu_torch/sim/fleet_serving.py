"""Fleet serving: one card flying a fleet of simulated vehicles.

The port's counterpart of ``examples/fleet_serving.py``, with its options,
its numbers and its PASS gate (mean tracking error below 0.35 m)::

    python -m sde4mbrl_px4_tpu_torch.sim.fleet_serving [--vehicles 64] [--seconds 8] [--cpu]
        [--solver apg|mppi|policy] [--refine-iters N] [--policy-dir D]

Every vehicle's receding-horizon solve is one scenario of the batched solve
(``parallel/fleet.py::FleetEngine`` over ``parallel/batched.py``: warm
starts on the card, plans pipelined: tick k is dispatched while tick k-1's
plans come home). ``--solver apg`` (the shipped posctrl config) is one
launch of the whole-solve kernel's scenario grid per tick; ``--solver
mppi`` runs the sampling solver over the cost oracle's scenario axis
(``--iters`` maps onto ``mppi.iters`` when it is not 100, as in the
example); ``--solver policy`` runs the shipped
``<policy-dir>/iris_posctrl_policy.pkl`` (default ``configs/models``), the
pure policy (one network pass, one ``value_batch`` and one ``trajectory``
launch per tick) or, with ``--refine-iters N``, the hybrid (N iterations
of the whole-solve kernel from the network's plan on cold starts). Each iris vehicle holds its own target on a 2 m
circle at 1 m altitude, and is stepped by its own plant: the port's
``ops/rollout.py::em_step`` over the fleet's (B, 13) states on the same
device, 10 Euler sub-steps per 50 ms tick (one 50 ms step is too coarse for
the attitude dynamics and limit-cycles). It prints the tick's busy time
(the host time of ``FleetEngine.step``) p50/p99 against the 50 ms budget,
the vehicle-solves a second that p50 gives, the device time of a tick's
solve, the plans' age, and the mean and max tracking error (and returns the
share of ticks over the period and the oldest plan's age in periods, the
gates of a soak, ``sim/soaks.py``). ``--cpu`` runs
the plain solves on the CPU (slow: one solve after the other).
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np

__all__ = ["run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_SUB = 10           # plant sub-steps per tick
PASS_MEAN_M = 0.35   # the gate of examples/fleet_serving.py:138


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sde4mbrl_px4_tpu_torch.sim.fleet_serving",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--vehicles", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--iters", type=int, default=100,
                    help="per-solve APG iteration budget (the shipped posctrl config's "
                         "max_iter)")
    ap.add_argument("--solver", default="apg", choices=("apg", "mppi", "policy"),
                    help="per-vehicle solver family")
    ap.add_argument("--policy-dir", default=None,
                    help="dir with iris_posctrl_policy.pkl (default: the shipped "
                         "checkpoints in configs/models)")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="with --solver policy: APG polish iterations per vehicle per "
                         "tick (policy.refine_iters)")
    ap.add_argument("--cpu", action="store_true", help="run the solves on the CPU")
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Fly the fleet; returns its numbers (``ok`` is the PASS gate)."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.rollout import em_step
    from sde4mbrl_px4_tpu_torch.parallel.fleet import FleetEngine

    B = args.vehicles
    cfg = load_yaml_config(os.path.join(_ROOT, "configs/iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = args.iters
    if args.solver == "mppi":
        cfg["solver"] = "mppi"
        # --iters is the sampling budget here (apg_mpc.max_iter is unused)
        if args.iters != 100:
            cfg["mppi"] = {"iters": args.iters}
    elif args.solver == "policy":
        ckpt = os.path.join(args.policy_dir or os.path.join(_ROOT, "configs", "models"),
                            "iris_posctrl_policy.pkl")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"missing {ckpt}: train the policy checkpoints first "
                                    f"(examples/policy_distill.py)")
        cfg["solver"] = "policy"
        cfg["policy"] = {"params_path": ckpt, "refine_iters": args.refine_iters}
    t0 = time.perf_counter()
    eng = FleetEngine(cfg, batch=B, seed=0, device="cpu" if args.cpu else None)
    dev, dt = eng.device, eng.dt
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {kind}  fleet size: {B}", flush=True)

    # per-vehicle hold targets on a circle: radius 2 m, 1 m up (ENU, as the
    # position config takes them)
    ang = 2 * np.pi * np.arange(B) / B
    targets = np.tile(hover_state().numpy(), (B, 1))
    targets[:, 0] = 2.0 * np.cos(ang)
    targets[:, 1] = 2.0 * np.sin(ang)
    targets[:, 2] = 1.0
    targets_ned = np.stack([targets[:, 1], targets[:, 0], -targets[:, 2]], axis=1)

    model, params = eng.bundle.model, eng.bundle.params
    h = torch.full((), dt / N_SUB, dtype=torch.float32, device=dev)
    states = hover_state(dev).expand(B, 13).contiguous()

    def plant_step(x, u):
        for _ in range(N_SUB):
            x = em_step(model, params, x, u, h)
        return x

    eng.reset(states.cpu().numpy())
    print(f"fleet engine ready in {time.perf_counter() - t0:.1f} s "
          f"(B={B} solves/tick, horizon {eng.H}, solver {args.solver}, max_iter "
          f"{eng.bundle.apg_config.max_iter})", flush=True)

    busy, device_ms, ages = [], [], []
    x_host = states.cpu().numpy()
    with torch.no_grad():
        for _ in range(int(round(args.seconds / dt))):
            t1 = time.perf_counter()
            # pipelined: the previous tick's plans, time-index picked
            u_now, _, age = eng.step(x_host, targets)
            busy.append(time.perf_counter() - t1)
            ages.append(age)
            if eng.device_ms is not None:
                device_ms.append(eng.device_ms)
            states = plant_step(states, torch.from_numpy(u_now).to(dev))
            x_host = states.cpu().numpy()

    errs = np.linalg.norm(x_host[:, :3] - targets_ned, axis=1)
    steady = lambda v: v[2:] or v          # past the cold ticks, where there are any
    p50, p99 = (float(np.percentile(steady(busy), q)) for q in (50, 99))
    res = {"vehicles": B, "device": kind, "solver": args.solver,
           "refine_iters": args.refine_iters, "ticks": len(busy), "busy_ms_p50": 1e3 * p50,
           "busy_ms_p99": 1e3 * p99, "vehicle_solves_per_s": B / p50, "budget_ms": 1e3 * dt,
           "device_ms_p50": statistics.median(steady(device_ms)) if device_ms else None,
           "age_ms_p50": 1e3 * statistics.median(steady(ages)), "first_age": ages[0],
           # the soak's gates (sim/soaks.py): ticks over the period, and the
           # oldest plan picked, in periods
           "over_budget_frac": float(np.mean(np.asarray(steady(busy)) > dt)),
           "age_ticks_max": int(round(max(steady(ages)) / dt)),
           "err_mean": float(errs.mean()), "err_max": float(errs.max())}
    res["ok"] = res["err_mean"] < PASS_MEAN_M
    dev_txt = ("not measured (CPU)" if res["device_ms_p50"] is None
               else f"{res['device_ms_p50']:.2f} ms")
    print(f"tick busy time: p50={res['busy_ms_p50']:.2f}ms p99={res['busy_ms_p99']:.2f}ms "
          f"(budget {res['budget_ms']:.0f}ms) => {res['vehicle_solves_per_s']:,.0f} "
          f"vehicle-solves/s; a tick's solve on the device p50 {dev_txt}; plan age "
          f"p50 {res['age_ms_p50']:.2f} ms", flush=True)
    print(f"fleet tracking after {args.seconds:.0f}s: mean={res['err_mean']:.3f}m "
          f"max={res['err_max']:.3f}m", flush=True)
    print("RESULT:", "PASS" if res["ok"] else "FAIL", flush=True)
    return res


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

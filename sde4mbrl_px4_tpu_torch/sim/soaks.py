"""Endurance soaks: the closed loop and the fleet flown for a minute each.

The reference's short runs missed two stability faults that its 60 s soaks
found (``docs/PERFORMANCE.md:313-333``); this drive flies the port's five
soaks at time-scale 1, one after the other in one process::

    python -m sde4mbrl_px4_tpu_torch.sim.soaks [--seconds 60] [--only iris,fleet]
        [--json out.json]

- ``iris``, ``hexa``: ``sim/closed_loop.py`` (the engine node on the card,
  the SDE plant on the host, UDP MAVLink) on the shipped linesearch APG
  configs;
- ``mppi``: the same with ``--solver mppi``;
- ``policy5``: ``--solver policy --refine-iters 5``, the hybrid;
- ``fleet``: ``sim/fleet_serving.py --vehicles 64``.

Each is held to the reference's soak gates: mean tracking error below
0.35 m, timeout ticks at most 2 % (the fleet: ticks whose busy time passes
the 50 ms period) and staleness at most 1 (the largest pickup index; the
fleet: the oldest plan picked, in periods). A table prints each reading
beside the reference's tracking error for the same soak
(``docs/PERFORMANCE.md:314-319``), and ``--json`` writes the readings.
Exit 0 only when every soak passes.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

__all__ = ["SOAKS", "run", "main"]

# name -> (drive arguments, the reference's tracking error over its 60 s
# soak, docs/PERFORMANCE.md:314-319)
SOAKS = {
    "iris": (["--vehicle", "iris"], 0.026),
    "hexa": (["--vehicle", "hexa"], 0.022),
    "mppi": (["--solver", "mppi"], 0.049),
    "policy5": (["--solver", "policy", "--refine-iters", "5"], 0.073),
    "fleet": (["--vehicles", "64"], 0.127),
}
MEAN_LT_M, TIMEOUT_FRAC, STALENESS = 0.35, 0.02, 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.soaks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--only", default=None,
                    help=f"comma-separated soaks (default: all of {', '.join(SOAKS)})")
    ap.add_argument("--json", default=None, help="write the readings here")
    return ap


def _reading(name: str, res: dict) -> dict:
    """A soak's gate figures from its drive's result."""
    if name == "fleet":
        row = {"err_mean_m": res["err_mean"], "err_max_m": res["err_max"],
               "timeout_frac": res["over_budget_frac"], "staleness": res["age_ticks_max"],
               "busy_ms_p50": res["busy_ms_p50"], "busy_ms_p99": res["busy_ms_p99"],
               "device_ms_p50": res["device_ms_p50"]}
    else:
        row = {"err_mean_m": res["err_mean_m"], "err_max_m": res["err_max_m"],
               "timeout_frac": res["timeout_frac"], "staleness": res["max_pickup_idx"],
               "watchdog_trips": res["watchdog_trips"], "solve_ms_p50": res["solve_ms_p50"],
               "iterations_p50": res["iterations_p50"], "fcu_status": res["fcu_status"]}
    row["ok"] = bool(row["err_mean_m"] < MEAN_LT_M and row["timeout_frac"] <= TIMEOUT_FRAC
                     and row["staleness"] <= STALENESS and (name == "fleet" or res["ok"]))
    return row


def run(argv: Optional[list] = None) -> dict:
    """Fly the soaks; returns ``{name: reading}`` (``ok`` each soak's gate)."""
    args = parser().parse_args(argv)
    from sde4mbrl_px4_tpu_torch.sim import closed_loop, fleet_serving

    names = args.only.split(",") if args.only else list(SOAKS)
    secs = ["--seconds", str(args.seconds)]
    readings = {}
    for name in names:
        extra, ref = SOAKS[name]
        print(f"== soak {name}: {args.seconds:.0f} s ==", flush=True)
        if name == "fleet":
            res = fleet_serving.run(extra + secs)
        else:
            res = closed_loop.run(extra + secs + ["--time-scale", "1"])
        readings[name] = dict(_reading(name, res), reference_err_m=ref, seconds=args.seconds)
    print(f"\n{'soak':>8} {'mean [m]':>9} {'max [m]':>8} {'reference [m]':>14} "
          f"{'timeout':>8} {'staleness':>9}  gate")
    for name, r in readings.items():
        print(f"{name:>8} {r['err_mean_m']:9.4f} {r['err_max_m']:8.4f} "
              f"{r['reference_err_m']:14.3f} {r['timeout_frac']:8.2%} {r['staleness']:9d}  "
              f"{'PASS' if r['ok'] else 'FAIL'}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)
    print(json.dumps({"soaks": readings}), flush=True)
    return readings


def main(argv: Optional[list] = None) -> int:
    return 0 if all(r["ok"] for r in run(argv).values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Uncertainty-aware MPC: 1024 Monte-Carlo SDE sample paths per solve.

The port's counterpart of ``examples/uncertainty_mpc.py``, with its options
and defaults::

    python -m sde4mbrl_px4_tpu_torch.sim.uncertainty [--particles 1024] [--cpu]

On ``configs/iris_posctrl_mpc.yaml`` at ``max_iter: 50``, from a start 1 m
off in x and 0.5 m low (NED z), holding the hover at the origin:

- low noise and high noise: the model's diffusion scale set to 0.02 and
  0.6 (the example sets ``diffusion_log_scale`` through a checkpoint; here
  on the loaded parameters), the plan's aggressiveness ``mean|du|``;
- antithetic paths; state noise (``initial_state_std``: 0.15 m position,
  0.1 m/s velocity, 0.05 rad/s rate, none on the quaternion); risk-averse
  (``risk_lambda: 2``), each at the checkpoint's own diffusion.

Each variant solves twice from the same start, the second warm (its
shifted plan and stepsize), and times the second: the wall time from
``mpc_fn``'s dispatch to its plan on the host (on the card the particle
solve is one launch of the whole-solve kernel's particle form and one of
``trajectory``). It prints ms per solve, iterations and ``opt_cost``.
``--cpu`` runs the plain versions (slow at P=1024: use ``--particles 8``).
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

__all__ = ["VARIANTS", "STATE_STD", "run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the example's state-estimate stds: position, velocity, quaternion, rates
STATE_STD = [0.15] * 3 + [0.1] * 3 + [0.0] * 4 + [0.05] * 3
# (label, diffusion scale or None for the checkpoint's, config mutation)
VARIANTS = (
    ("low-noise", 0.02, {}),
    ("high-noise", 0.6, {}),
    ("antithetic", None, {"antithetic": True}),
    ("state-noise", None, {"initial_state_std": STATE_STD}),
    ("risk-averse", None, {"cost_params.risk_lambda": 2.0}),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.uncertainty",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    ap.add_argument("--particles", type=int, default=1024)
    return ap


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(particles: int = 1024, device=None, max_iter: int = 50) -> dict:
    """Solve every variant (module docstring); returns ``{label: {"ms",
    "opt_cost", "steps", "mean_du"}}`` and prints a line each."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    base = load_yaml_config(os.path.join(_ROOT, "configs/iris_posctrl_mpc.yaml"))
    base["num_particles"] = particles
    base["apg_mpc"]["max_iter"] = max_iter
    results = {}
    for label, scale, mut in VARIANTS:
        cfg = copy.deepcopy(base)
        for key, val in mut.items():
            blk, parts = cfg, key.split(".")
            for p in parts[:-1]:
                blk = blk[p]
            blk[parts[-1]] = val
        _, (reset_fn, mpc_fn), _, b = make_mpc_from_config(cfg, device=device)
        dev = b.device
        if scale is not None:
            b.params["diffusion_log_scale"].fill_(math.log(scale))
        x0 = hover_state(dev)
        x0[0], x0[2] = 1.0, 0.5                        # the offset start (NED)
        tgt = hover_state(dev)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            sol = mpc_fn(x0, gen, reset_fn(x0, gen, x0), 0.0, tgt)
            _sync(dev)
            t0 = time.perf_counter()
            sol = mpc_fn(x0, gen, sol.opt_state, 0.0, tgt)
            u = sol.u_opt.cpu().numpy()
            ms = 1e3 * (time.perf_counter() - t0)
        res = {"ms": ms, "opt_cost": float(sol.opt_state.opt_cost),
               "steps": int(sol.opt_state.num_steps),
               "mean_du": float(np.abs(np.diff(u, axis=0)).mean())}
        results[label] = res
        print(f"{label:>11}: solve {ms:8.2f} ms  {res['steps']:3d} it.  mean|du| "
              f"{res['mean_du']:.4f}  opt_cost {res['opt_cost']:.3f}", flush=True)
    lo, hi = results["low-noise"]["mean_du"], results["high-noise"]["mean_du"]
    print(f"\nplan aggressiveness low-noise={lo:.4f} vs high-noise={hi:.4f}", flush=True)
    return results


def main(argv: Optional[list] = None) -> int:
    args = parser().parse_args(argv)
    import torch

    device = "cpu" if args.cpu else None
    name = "cpu" if args.cpu else torch.cuda.get_device_name(0) if \
        torch.cuda.is_available() else "no CUDA card"
    print(f"device: {name}; {args.particles} particles, max_iter 50", flush=True)
    results = run(args.particles, device)
    ok = all(np.isfinite([r["opt_cost"], r["ms"]]).all() for r in results.values())
    print(f"{args.particles}-particle risk-aware planning: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

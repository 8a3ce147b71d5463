"""Tune the MPPI solver's exploration knobs on the card.

The port's counterpart of ``tools/tune_mppi.py``, with its flags: a whole
grid of candidate (sigma, temperature, noise_beta) controllers flies the
closed loop together, one scenario of a batched solve each
(``tuning/tuner.py::tune_mppi``: a period is ``iters + 2`` ``value_batch``
launches over N x K plans and one ``trajectory`` launch), then the ranked
table and the winning ``mppi:`` block are printed::

    python -m sde4mbrl_px4_tpu_torch.sim.tune_mppi configs/iris_posctrl_mpc.yaml
    python -m sde4mbrl_px4_tpu_torch.sim.tune_mppi configs/iris_traj_mpc.yaml \\
        --sigmas 0.01,0.02,0.04 --temps 0.05,0.1,0.2 --betas 0.0,0.5,0.7 --steps 60

``--mesh-dp`` above 1 (the candidates sharded over devices) waits for more
than one GPU and is refused. ``--cpu`` runs the plain solves on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

__all__ = ["run", "main"]


def _floats(s):
    return [float(v) for v in s.split(",") if v]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.tune_mppi",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="MPC YAML (solver forced to mppi)")
    ap.add_argument("--sigmas", type=_floats, default=[0.01, 0.02, 0.04])
    ap.add_argument("--temps", type=_floats, default=[0.05, 0.1, 0.2])
    ap.add_argument("--betas", type=_floats, default=[0.0, 0.5, 0.7])
    ap.add_argument("--steps", type=int, default=40,
                    help="closed-loop control periods per candidate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-crn", action="store_true",
                    help="independent noise per candidate (default: common random numbers)")
    ap.add_argument("--mesh-dp", type=int, default=0,
                    help="shard the candidate axis over a dp mesh of this size (0 = single "
                         "device; more than one device is not ported)")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Sweep and print; returns ``{"results", "wall_s", "solves_per_s",
    "samples", "iters"}``."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import not_in_slice
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig
    from sde4mbrl_px4_tpu_torch.tuning import make_mppi_grid, tune_mppi

    if args.mesh_dp > 1:
        raise not_in_slice(f"--mesh-dp {args.mesh_dp} (a candidate grid sharded over "
                           f"devices)", "Batched and fleet over more than one GPU")
    cfg = load_yaml_config(args.config)
    cfg["solver"] = "mppi"
    static = MPPIConfig.from_config(cfg)
    grid = make_mppi_grid(args.sigmas, args.temps, args.betas)
    device = "cpu" if args.cpu else None
    name = "cpu" if args.cpu else (torch.cuda.get_device_name(0)
                                   if torch.cuda.is_available() else "no CUDA card")
    print(f"device: {name}")
    print(f"sweeping {grid.shape[0]} candidates x {args.steps} control periods "
          f"(K={static.samples}, iters={static.iters}) ...", flush=True)
    t0 = time.time()
    results = tune_mppi(cfg, grid, steps=args.steps, seed=args.seed, crn=not args.no_crn,
                        device=device)
    wall = time.time() - t0
    n_solves = grid.shape[0] * args.steps
    print(f"done in {wall:.1f}s ({n_solves} closed-loop solves, "
          f"{n_solves / wall:.0f} solves/s incl. the build)\n")
    print(f"{'rank':>4} {'sigma':>8} {'temp':>8} {'beta':>6} "
          f"{'mean err [m]':>13} {'final err [m]':>14}")
    for i, r in enumerate(results[: args.top]):
        print(f"{i + 1:>4} {r.sigma:>8.4g} {r.temperature:>8.4g} "
              f"{r.noise_beta:>6.3g} {r.mean_pos_err:>13.4f} {r.final_pos_err:>14.4f}")
    print("\nbest candidate as a config block:\n")
    print(results[0].yaml_block(static.samples, static.iters), flush=True)
    return {"results": results, "wall_s": wall, "solves_per_s": n_solves / wall,
            "samples": static.samples, "iters": static.iters}


def main(argv: Optional[list] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

``--mesh-dp N`` above 1 shards the candidates over a dp mesh of N ranks
(``tuning/tuner.py``'s ``mesh``; the original's ``:42-75``): inside a
process group of N ranks (``SDE4MBRL_COORDINATOR`` /
``SDE4MBRL_NUM_PROCESSES`` / ``SDE4MBRL_PROCESS_ID``, or ``torchrun`` with
``SDE4MBRL_AUTO_DISTRIBUTED=1``) every rank runs this drive and joins that
world; otherwise the drive spawns the N ranks itself
(``parallel/distributed.py::spawn_ranks``, a gloo group on a ``file://``
store), each rank on ``cuda:(rank % device_count)`` (one card: the ranks
share it) or, with ``--cpu``, on the CPU, and prints rank 0's table.
``--cpu`` runs the plain solves on the CPU.
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
                    help="shard the candidate axis over a dp mesh of this many ranks (0 = "
                         "one process): joins the process group that exists, else spawns "
                         "the ranks")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Sweep and print; returns ``{"results", "wall_s", "solves_per_s",
    "samples", "iters"}``."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.parallel.distributed import (
        global_mesh, initialize_distributed, spawn_ranks)
    from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig
    from sde4mbrl_px4_tpu_torch.tuning import make_mppi_grid, tune_mppi

    cfg = load_yaml_config(args.config)
    cfg["solver"] = "mppi"
    static = MPPIConfig.from_config(cfg)
    grid = make_mppi_grid(args.sigmas, args.temps, args.betas)
    device = "cpu" if args.cpu else None
    name = "cpu" if args.cpu else (torch.cuda.get_device_name(0)
                                   if torch.cuda.is_available() else "no CUDA card")
    mesh = None
    in_world = args.mesh_dp > 1 and initialize_distributed()
    if in_world:
        mesh = global_mesh((args.mesh_dp, 1), devices=device)
    print(f"device: {name}")
    print(f"sweeping {grid.shape[0]} candidates x {args.steps} control periods "
          f"(K={static.samples}, iters={static.iters}"
          f"{', dp=' + str(args.mesh_dp) if args.mesh_dp > 1 else ''}) ...", flush=True)
    t0 = time.time()
    kw = dict(steps=args.steps, seed=args.seed, crn=not args.no_crn)
    if args.mesh_dp > 1 and not in_world:
        results = spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:tune", args.mesh_dp,
                              dict(kind="mppi", cfg=cfg, grid=grid, devices=device, **kw),
                              timeout=3600.0)[0]["results"]
    else:
        results = tune_mppi(cfg, grid, mesh=mesh, device=device, **kw)
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

"""Evaluate a learned SDE model against a recorded flight.

The port's counterpart of ``tools/eval_model.py``, with its options and
defaults; prints a JSON report: open-loop k-step prediction RMSE of the
mean dynamics and Monte-Carlo ensemble calibration
(``learning/evaluate.py``)::

    python -m sde4mbrl_px4_tpu_torch.sim.eval_model flight.npz --vehicle iris \\
        [--checkpoint configs/models/iris_sde.pkl] [--ks 1,5,10,20] \\
        [--calib-k 10] [--particles 128] [--cpu]

The calibration's Brownian draws come from a ``torch.Generator`` seeded
with 0 (the JAX package's threefry draws have no torch twin, so its
coverage numbers differ within sampling noise). Runs on the card unless
``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

__all__ = ["main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.eval_model",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("log", help=".npz flight log (io/flight_log.py)")
    ap.add_argument("--vehicle", default="iris", help="iris | hexa")
    ap.add_argument("--checkpoint", default=None,
                    help="model .pkl (default: configs/models/<vehicle>_sde.pkl)")
    ap.add_argument("--ks", default="1,5,10,20")
    ap.add_argument("--calib-k", type=int, default=10)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from sde4mbrl_px4_tpu_torch.learning import evaluate_model, sequence_from_flight_log
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import vehicle_from_name

    ckpt = args.checkpoint or os.path.join(_ROOT, "configs", "models", f"{args.vehicle}_sde.pkl")
    model = NeuralSDE.for_vehicle(vehicle_from_name(args.vehicle))
    params, _ = load_params(ckpt)
    t, x, u = sequence_from_flight_log(args.log, n_u=model.n_u)
    ks = tuple(int(k) for k in args.ks.split(","))
    need = max(max(ks), args.calib_k) + 2
    if t.shape[0] < need:
        sys.exit(f"error: log has only {t.shape[0]} commanded samples; "
                 f"need >= {need} for the requested horizons")
    report = evaluate_model(model, params, t, x, u, ks=ks, calib_k=args.calib_k,
                            num_particles=args.particles, device="cpu" if args.cpu else None)
    report["checkpoint"] = ckpt
    report["samples"] = int(t.shape[0])
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()

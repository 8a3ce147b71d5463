"""Model learning demo: flight data -> trained SDE -> a better model.

The port's counterpart of ``examples/train_model.py``, with its options,
defaults and ``RESULT:`` gate::

    python -m sde4mbrl_px4_tpu_torch.sim.train_model [--cpu] [--steps 800]
        [--out configs/models/iris_sde_trained.pkl]

A "true" iris whose motor gains are off by (+8 %, -5 %, +3 %) flies short
episodes of hover-plus-excitation commands (``--steps`` samples at 50 Hz,
episodes of 40 with resets); the SDE is fitted to them with
``learning/trainer.py::train_sde`` (window 6, batch 128, 400 steps, lr
3e-3) from a fresh init; the gate: the trained model's 20-step open-loop
error on held-out excitation is below 0.8 of the prior's. Both models are
drawn from seeded ``torch.Generator``s (the numbers differ from the JAX
package's threefry draws). Training runs on the card unless ``--cpu``;
besides the example's lines it prints the training steps per second.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

__all__ = ["run", "main"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.train_model",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--out", default=None)
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Generate, train, compare; returns the numbers (``ok`` is the gate)."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.device import resolve_device
    from sde4mbrl_px4_tpu_torch.learning.trainer import TrainConfig, TrajectoryDataset, train_sde
    from sde4mbrl_px4_tpu_torch.models.params_io import (
        params_from_numpy, params_to_numpy, save_params)
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    dev = resolve_device("cpu" if args.cpu else None)
    model = NeuralSDE.for_vehicle(iris_config(), dev)
    # "true" vehicle: motor gains off and a residual the prior does not know
    true = params_to_numpy(init_params(torch.Generator().manual_seed(9), model))
    true["motor"]["log_gain"] = np.array([0.08, -0.05, 0.03, 0.0], np.float32)
    true = params_from_numpy(true, dev)

    print("== generating flight data (episodic excitation) ==", flush=True)
    dt, ep_len = 0.02, 40
    dts1 = torch.full((1,), dt, device=dev)
    rs = np.random.RandomState(0)
    xs, us = [], []
    k = 0
    with torch.no_grad():
        while len(us) < args.steps:
            x = hover_state().numpy()
            x[3:6] += 0.2 * rs.randn(3)
            for _ in range(ep_len):
                u = np.clip(model.vehicle.hover_u + 0.05 * np.sin(0.15 * k + np.arange(4) * 1.7)
                            + 0.02 * rs.randn(4), 1e-4, 1.0).astype(np.float32)
                xs.append(x.astype(np.float32))
                us.append(u)
                path = rollout_mean(model, true, torch.from_numpy(xs[-1]).to(dev),
                                    torch.from_numpy(u).to(dev)[None], dts1)
                x = path[1].cpu().numpy()
                k += 1
    t = np.arange(len(us)) * dt
    x_data, u_data = np.stack(xs), np.stack(us)
    assert np.isfinite(x_data).all(), "flight data diverged"
    print(f"data: {x_data.shape[0]} samples, max|v|={np.abs(x_data[:, 3:6]).max():.2f} m/s",
          flush=True)

    print("== training ==", flush=True)
    cfg = TrainConfig(window=6, batch_size=128, steps=400, lr=3e-3)
    ds = TrajectoryDataset(t, x_data, u_data, cfg.window)
    init = init_params(torch.Generator().manual_seed(1), model, device=dev)
    t0 = time.perf_counter()
    trained, metrics = train_sde(model, init, ds, cfg, log_every=100, device=dev)
    train_s = time.perf_counter() - t0
    print(f"trained in {train_s:.1f}s ({cfg.steps / train_s:.1f} steps/s), "
          f"final loss {metrics['final_loss']:.4f}")

    # open-loop prediction comparison on held-out excitation
    x0 = torch.from_numpy(x_data[-30]).to(dev)
    useq = torch.from_numpy(u_data[-30:-10]).to(dev)
    dts = torch.full((20,), dt, device=dev)
    with torch.no_grad():
        ref = rollout_mean(model, true, x0, useq, dts)
        e_prior = float(torch.linalg.norm(rollout_mean(model, init, x0, useq, dts)[-1, :6]
                                          - ref[-1, :6]))
        e_train = float(torch.linalg.norm(rollout_mean(model, trained, x0, useq, dts)[-1, :6]
                                          - ref[-1, :6]))
    print(f"20-step open-loop error: prior {e_prior:.4f} -> trained {e_train:.4f}")
    if args.out:
        save_params(args.out, trained, meta={"vehicle": "iris", "hidden": 64, "version": 2,
                                             "trained": True})
        print(f"checkpoint written: {args.out}")
    ok = e_train < e_prior * 0.8
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return {"ok": ok, "samples": int(x_data.shape[0]), "train_steps": cfg.steps,
            "train_s": train_s, "steps_per_s": cfg.steps / train_s,
            "final_loss": metrics["final_loss"], "e_prior": e_prior, "e_train": e_train,
            "device": str(dev), "out": args.out}


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

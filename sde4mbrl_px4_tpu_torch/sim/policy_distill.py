"""Distill the APG MPC into a one-shot policy, then fly it.

The port's counterpart of ``examples/policy_distill.py``, with its options,
defaults and ``RESULT:`` gate::

    python -m sde4mbrl_px4_tpu_torch.sim.policy_distill [--cpu] [--n-states 4096]
        [--steps 3000] [--outdir <tmp>/policy_ckpts] [--seconds 8]

For the vehicle's traj and posctrl configs (``learning/distill.py``):
sample ``--n-states`` states, label each with a converged APG solve (on
the card one launch of the whole-solve kernel over all of them, at
``--expert-iters``), train the plan network (``--hidden``, ``--steps``),
``--dagger-rounds`` rounds of ``--dagger-rollouts`` policy flights, and
save ``<outdir>/<vehicle>_<kind>_policy.pkl``. Then the shoot-out on the
lemniscate: APG and the distilled traj policy (``solver: policy``), each
chained through ``mpc_fn`` on the model's mean dynamics for ``--seconds``;
the gate: the policy's mean tracking error below ``max(4 err_apg, 0.25)``
m. The example shards its labels over the device mesh; this drive labels
in its own process on one card (``learning/distill.py::distill_policy``
takes ``mesh=``, a mesh of ranks, ``parallel/mesh.py``). Besides the example's
lines it prints each label call's seconds and labels per second, and the
training steps per second.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np

__all__ = ["closed_loop", "run", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.policy_distill",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--vehicle", default="iris", choices=("iris", "hexa"))
    ap.add_argument("--n-states", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--expert-iters", type=int, default=300)
    ap.add_argument("--dagger-rounds", type=int, default=1)
    ap.add_argument("--dagger-rollouts", type=int, default=32)
    ap.add_argument("--hidden", type=int, nargs="+", default=[256, 256])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(), "policy_ckpts"))
    return ap


def closed_loop(mpc_fn, reset_fn, cfg, sft, seconds: float, dev):
    """Chained receding-horizon flight on the model's mean dynamics (the
    example's ``:36-64``): ``(mean tracking error m, ms per solve, solves)``,
    one warm solve first."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned

    dt = cfg["_time_steps"][0]
    n = int(seconds / dt)
    x = enu2ned(sft(0.0))
    st = reset_fn(x, None, x)
    mpc_fn(x, None, st, 0.0, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    errs = []
    t = 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        sol = mpc_fn(x, None, st, t, x)
        st, x = sol.opt_state, sol.x_evol[1]
        t += dt
        errs.append(float(torch.linalg.norm(x[:3] - enu2ned(sft(t))[:3])))
    wall = time.perf_counter() - t0
    return float(np.mean(errs)), 1e3 * wall / n, n


def run(argv: Optional[list] = None) -> dict:
    """Distill both configs, fly the shoot-out; returns the numbers (``ok``
    is the gate)."""
    args = parser().parse_args(argv)
    import torch

    from sde4mbrl_px4_tpu_torch.device import resolve_device
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.learning.distill import DistillConfig, distill_policy, save_policy

    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    os.makedirs(args.outdir, exist_ok=True)
    results, distilled = {}, {}
    for kind in ("traj", "posctrl"):
        cfg = load_yaml_config(os.path.join(_ROOT, f"configs/{args.vehicle}_{kind}_mpc.yaml"))
        dcfg = DistillConfig(n_states=args.n_states, steps=args.steps,
                             expert_max_iter=args.expert_iters, dagger_rounds=args.dagger_rounds,
                             dagger_rollouts=args.dagger_rollouts, hidden=tuple(args.hidden),
                             lr=args.lr)
        print(f"== distilling {kind} expert ({args.n_states} states, "
              f"{args.expert_iters}-iter labels) ==", flush=True)
        t0 = time.perf_counter()
        params, stats = distill_policy(cfg, dcfg, verbose=True, device=dev)
        for n, s in stats["label_calls"]:
            print(f"  label call: {n} states in {s:.3f} s ({n / s:.1f} labels/s)")
        print(f"  labeled in {stats['label_s']:.1f}s "
              f"({args.n_states / max(stats['label_s'], 1e-9):.0f} solves/s), "
              f"trained in {stats['train_s']:.1f}s ({args.steps / stats['train_s']:.1f} steps/s), "
              f"loss {stats['losses'][0]:.5f} -> {stats['losses'][-1]:.5f}, "
              f"total {time.perf_counter() - t0:.1f}s")
        ckpt = os.path.join(args.outdir, f"{args.vehicle}_{kind}_policy.pkl")
        save_policy(ckpt, params, {"vehicle": args.vehicle, "cfg": kind})
        print(f"  saved {ckpt}")
        results[kind] = ckpt
        distilled[kind] = {k: v for k, v in stats.items() if k != "losses"}
        distilled[kind]["losses"] = [stats["losses"][0], stats["losses"][-1]]

    # closed-loop shoot-out on the lemniscate
    base = load_yaml_config(os.path.join(_ROOT, f"configs/{args.vehicle}_traj_mpc.yaml"))
    cfg_apg = dict(base)
    _, (reset_a, mpc_a), sft, _ = make_mpc_from_config(cfg_apg, device=dev)
    err_a, ms_a, n = closed_loop(mpc_a, reset_a, cfg_apg, sft, args.seconds, dev)
    cfg_pol = dict(base)
    cfg_pol["solver"] = "policy"
    cfg_pol["policy"] = {"params_path": results["traj"]}
    _, (reset_p, mpc_p), sft_p, _ = make_mpc_from_config(cfg_pol, device=dev)
    err_p, ms_p, _ = closed_loop(mpc_p, reset_p, cfg_pol, sft_p, args.seconds, dev)
    print(f"\n== closed loop, {n} control steps of the lemniscate ==")
    print(f"  APG    : {err_a:.3f} m mean tracking, {ms_a:.2f} ms/solve")
    print(f"  policy : {err_p:.3f} m mean tracking, {ms_p:.2f} ms/solve "
          f"({ms_a / max(ms_p, 1e-9):.1f}x faster)")
    print(f"\nServe it: add to {args.vehicle}_traj_mpc.yaml:\n"
          f"  solver: policy\n  policy:\n    params_path: {results['traj']}")
    gate = max(4.0 * err_a, 0.25)
    ok = err_p < gate
    print(f"RESULT: {'PASS' if ok else 'FAIL'} (policy {err_p:.3f} m vs gate {gate:.3f} m)",
          flush=True)
    return {"ok": ok, "checkpoints": results, "distill": distilled, "ticks": n,
            "steps": args.steps, "err_apg_m": err_a, "err_policy_m": err_p, "gate_m": gate,
            "apg_ms": ms_a,
            "policy_ms": ms_p, "device": str(dev)}


def main(argv: Optional[list] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

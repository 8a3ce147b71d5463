"""Constrained MPC demo: velocity and body-rate boxes by proximal slack.

The port's counterpart of ``examples/constrained_mpc.py``, with its
options, prints and gate: an aggressive 3 m setpoint step (NED x) is flown
from hover with and without the ``state_constr`` block of
``configs/iris_constr_posctrl_mpc.yaml``, ``--steps`` chained solves each
(the vehicle moved to ``x_evol[1]`` after each), and the peak |v| and
|omega| along the predicted paths and the final position error are
printed; ``RESULT: PASS`` when the constrained flight's peak speed is below
the unconstrained one's and below 0.75 m/s (the original's ``:40-72``)::

    python -m sde4mbrl_px4_tpu_torch.sim.constrained_mpc [--steps 100] [--cpu]

On the card each tick is one launch of the whole-solve kernel (its
proximal form with the box, ``<false, prox>``, else ``<false, none>``).
``--cpu`` runs the plain solves on the CPU (tens of ms an iteration:
``--max-iter`` caps the solves there, a shorter run than the original's).
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Any, Dict, Optional

__all__ = ["fly", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(_ROOT, "configs", "iris_constr_posctrl_mpc.yaml")
V_BOX_GATE = 0.75     # m/s, the original's gate (:69)


def fly(cfg: Dict[str, Any], steps: int, device=None) -> dict:
    """``steps`` chained solves of the 3 m step from hover on ``cfg``:
    ``{"v", "w", "err", "plans"}``, the peak |v| (m/s) and |omega| (rad/s)
    of the predicted paths, the final distance to the target (m) and each
    tick's plan (H, n_u) on the host."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    _, (reset_fn, mpc_fn), _, b = make_mpc_from_config(copy.deepcopy(cfg), device=device)
    dev = b.device
    x = hover_state(dev)
    target = hover_state(dev)
    target[0] = 3.0                       # 3 m step (solver frame)
    xdes = ned2enu(target)                # the API takes ENU
    st = reset_fn(x, None, x)
    v_max = w_max = 0.0
    plans = []
    for _ in range(steps):
        u, st, _, x_evol = mpc_fn(x, None, st, 0.0, xdes)
        xe = x_evol.cpu()
        plans.append(u.cpu().numpy())
        v_max = max(v_max, float(xe[1:, 3:6].abs().max()))
        w_max = max(w_max, float(xe[1:, 10:13].abs().max()))
        x = x_evol[1]
    return {"v": v_max, "w": w_max, "err": float(torch.linalg.norm(x[:3] - target[:3])),
            "plans": plans}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sde4mbrl_px4_tpu_torch.sim.constrained_mpc",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain solves on the CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="cap the solves' iterations (default: the config's)")
    args = ap.parse_args(argv)
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    device = "cpu" if args.cpu else None

    def run(constrained: bool) -> dict:
        cfg = load_yaml_config(CONFIG)
        if not constrained:
            cfg.pop("state_constr")
        if args.max_iter:
            cfg["apg_mpc"].update(max_iter=args.max_iter,
                                  max_no_improvement_iter=args.max_iter)
        return fly(cfg, args.steps, device)

    unc, con = run(False), run(True)
    print(f"unconstrained: |v|max={unc['v']:.2f} m/s  |w|max={unc['w']:.2f} rad/s  "
          f"final err={unc['err']:.2f} m")
    print(f"constrained:   |v|max={con['v']:.2f} m/s  |w|max={con['w']:.2f} rad/s  "
          f"final err={con['err']:.2f} m   (boxes: v 0.5 m/s, w 0.7-0.8 rad/s)")
    ok = con["v"] < unc["v"] and con["v"] < V_BOX_GATE
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""How far each particle form's kernel lies from its plain twin of the same
precision, in fp32 and with the bf16 trunk, on one card: the measurement
behind ``chip_smoke.py``'s ``BF16_TOL`` and the card tolerances of
``tests/test_torch_precision.py``.

    python3 sde4mbrl_px4_tpu_torch/bf16_floor.py

On ``chip_smoke.py``'s iris traj problem at P = 512 and 1024 antithetic,
without options, with risk (``risk_lambda`` 2), with the example's
state-noise starts and with both, over three draws each: the whole solve
at a fixed 5 iterations (the plan's largest |du|, ``grad_sqr`` relative),
``value_and_grad`` (value relative, the gradient's largest difference over
its largest entry) and ``value_batch`` at K = 1 and 4 (costs relative).
Prints one line ``BF16_FLOOR {json}`` per case, then ``BF16_FLOOR_MAX
{json}``, per option set and precision the largest of each metric, and
the card's name and power limit.

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import sys

OPTION_SETS = ((), ("risk",), ("starts",), ("risk", "starts"))


def measure(cs, P: int, opts: tuple, seed: int, dev) -> dict:
    """Per precision, each metric of the kernel against its plain twin."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    b = cs.make_bundle("iris_traj_mpc", dev)
    x0, x_ref, u_prev, u_init = cs.problem(b, dev)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    z = cs.brownian(P, dev, antithetic=True, seed=seed)
    cp, starts = cs.with_options(b, opts, x0, P, dev, seed=P + seed)
    args = (b.model, b.params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P, b.lb, b.ub,
            u_init)
    oargs = (b.model, b.params, cp, b.time_steps, x0, x_ref, u_prev, z, P, 4)
    u, U = cs.plans(1, 3, dev)[0].contiguous(), cs.plans(4, 4, dev)
    fns = {"du": lambda a, b: float((a - b).abs().max()), "gsq": cs._rel, "value": cs._rel,
           "grad": cs._scaled, "cost": cs._rel}
    out = {}
    for bf16 in (False, True):
        got = []
        for solve, oracle in ((AK.apg_solve_kernel, CO.cost_oracle),
                              (AK.apg_solve_plain, CO.cost_oracle_plain)):
            st = solve(*args, precond=b.precond, starts=starts, bf16=bf16)[0]
            o = oracle(*oargs, starts=starts, bf16=bf16)
            v, g = o.value_and_grad(u)
            got.append({"du": st.yk, "gsq": st.grad_sqr, "value": v, "grad": g,
                        "cost": torch.cat([o.value_batch(U[:1]), o.value_batch(U)])})
        out["bf16" if bf16 else "fp32"] = {m: fns[m](got[0][m], got[1][m]) for m in fns}
    return out


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("bf16_floor: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy

    apply_fp32_policy()
    dev = torch.device("cuda")
    worst = {}
    for P in (cs.P_FULL, cs.P_LARGE):
        for opts in OPTION_SETS:
            for seed in (0, 7, 13):
                r = measure(cs, P, opts, seed, dev)
                print("BF16_FLOOR " + json.dumps({"P": P, "options": list(opts), "seed": seed,
                                                  **r}), flush=True)
                for prec, errs in r.items():
                    w = worst.setdefault(f"{' + '.join(opts) or 'none'}, {prec}", {})
                    for m, e in errs.items():
                        w[m] = max(w.get(m, 0.0), e)
    print("BF16_FLOOR_MAX " + json.dumps(worst))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

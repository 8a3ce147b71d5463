"""The two wide P=1 forms against each other, on one card: the trunk's
weights in the block's shared-memory copy of the consts (``P1_SMEM``) or
read from device memory (``P1_GLOBAL``), on the same trunks.

    python3 sde4mbrl_px4_tpu_torch/p1_step_ab.py

On ``chip_smoke.py``'s iris problems at 32, 72 and 128 hidden units
(``chip_smoke.py::wide_params``; both forms take these, the libraries
pick ``P1_SMEM``), each P=1 kernel off the register chain (the whole solve
and ``value_and_grad`` on the wide step, ``value_batch`` and ``trajectory``
on the shared-memory step) is launched on the same inputs in both forms, in
the order SMEM, GLOBAL, GLOBAL, SMEM, and timed with CUDA events (mean per
launch, warm):

- the whole solve on the traj problem at a fixed 50 iterations (B = 1),
  and at a fixed 20 iterations over B = 256 scenarios (x0 spread);
- ``value_and_grad`` (B = 1), ``value_batch`` at K = 1, 64 and 1024, and
  ``trajectory``, on the posctrl problem.

Each output is compared bit for bit across the two forms. Prints one line
``P1_STEP_AB {json}`` per width (each kernel's SMEM and GLOBAL ms, their
ratio, and whether the bits agree), then the card's name and power limit.

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

HIDS = (32, 72, 128)


@contextlib.contextmanager
def forced(step: int):
    """The wrappers' consts name the trunk's form ``step``
    (``ApgArgs.step``: at P=1 any ``P1_*`` form, on the particle forms
    ``P1_SMEM`` or ``P1_GLOBAL``) for the duration, in place of the
    libraries' choice by shape (measurement only)."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    build = AK.build_consts

    def named(*args, **kw):
        consts, a = build(*args, **kw)
        a.step = step
        return consts, a

    AK.build_consts = CO.build_consts = named
    try:
        yield
    finally:
        AK.build_consts = CO.build_consts = build


@contextlib.contextmanager
def grouped(groups: int):
    """The wrappers plan the particle global-weight forms' spread
    (``ApgArgs.groups``, ``consts.plan_groups``) at ``groups`` clusters'
    worth of blocks a scenario (``value_batch``: a plan), or fewer where the chunks run out, in place
    of the most the card holds at once (measurement only: 1 is one cluster a
    scenario, the form's plan before the spread). A plan the card cannot
    hold is refused at launch."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    plan = AK.plan_groups

    def pinned(a, form, resident, plans=1):
        plan(a, form, int(groups) * int(a.batch) * int(plans) * int(a.cluster), plans)

    AK.plan_groups = CO.plan_groups = pinned
    try:
        yield
    finally:
        AK.plan_groups = CO.plan_groups = plan


def timed(fn, n: int) -> float:
    """Mean device ms of ``fn()`` over ``n`` warm calls (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def cases(cs, hid: int, dev) -> dict:
    """name -> (make, launches to time): ``make()``, run under :func:`forced`,
    builds what the call needs (so its form) and returns the call, which
    returns its outputs. The whole solve builds its consts in every call,
    as the route does; the oracle kernels are timed on one oracle."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    tb = cs.make_bundle("iris_traj_mpc", dev)
    tp = cs.wide_params(tb.params, hid)
    x0, x_ref, u_prev, u_init = cs.problem(tb, dev)

    def solve(iters: int, B: int):
        apg = tb.apg_config._replace(max_iter=iters, max_no_improvement_iter=iters, atol=0.0,
                                     rtol=0.0)
        if B == 1:
            return lambda: lambda: AK.apg_solve_kernel(
                tb.model, tp, tb.cost_params, apg, tb.time_steps, x0, x_ref, u_prev, None, 1,
                tb.lb, tb.ub, u_init, precond=tb.precond)
        X0 = x0.expand(B, 13).clone()
        X0[:, 0] += 0.01 * torch.arange(B, device=dev)
        XR = x_ref.expand(B, *x_ref.shape).contiguous()
        UP, UI = u_prev.expand(B, -1).contiguous(), u_init.expand(B, *u_init.shape).contiguous()
        return lambda: lambda: AK.apg_solve_kernel_batched(
            tb.model, tp, tb.cost_params, apg, tb.time_steps, X0, XR, UP, None, 1, tb.lb, tb.ub,
            UI, precond=tb.precond)

    ob = cs.make_bundle("iris_posctrl_mpc", dev)
    op = cs.wide_params(ob.params, hid)
    y0, y_ref, v_prev, _ = cs.problem(ob, dev)
    oargs = (ob.model, op, ob.cost_params, ob.time_steps, y0, y_ref, v_prev, None, 1, 4)
    U, u = cs.plans(1024, 1, dev), cs.plans(1, 2, dev)[0]

    def oracle(call):
        def make():
            o = CO.cost_oracle(*oargs)
            return lambda: call(o)
        return make

    return {
        "apg_solve_50it": (solve(50, 1), 10),
        "apg_solve_B256_20it": (solve(20, 256), 5),
        "value_and_grad": (oracle(lambda o: o.value_and_grad(u)), 100),
        "value_batch_K1": (oracle(lambda o: o.value_batch(U[:1])), 100),
        "value_batch_K64": (oracle(lambda o: o.value_batch(U[:64])), 100),
        "value_batch_K1024": (oracle(lambda o: o.value_batch(U)), 50),
        "trajectory": (oracle(lambda o: o.trajectory(u)), 100)}


def flat(out) -> list:
    """The tensors of a kernel call's output, in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    if hasattr(out, "_fields"):
        return [t for o in out for t in flat(o)]
    return []


def measure(cs, hid: int, dev) -> dict:
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import P1_GLOBAL, P1_SMEM

    res = {}
    for name, (make, n) in cases(cs, hid, dev).items():
        ms = {P1_SMEM: [], P1_GLOBAL: []}
        outs = {}
        for step in (P1_SMEM, P1_GLOBAL, P1_GLOBAL, P1_SMEM):
            with forced(step):
                call = make()
                outs[step] = [t.clone() for t in flat(call())]
                ms[step].append(timed(call, n))
        same = all(torch.equal(a, b) for a, b in zip(outs[P1_SMEM], outs[P1_GLOBAL]))
        s, g = sum(ms[P1_SMEM]) / 2, sum(ms[P1_GLOBAL]) / 2
        res[name] = {"smem_ms": ms[P1_SMEM], "global_ms": ms[P1_GLOBAL], "smem_mean": s,
                     "global_mean": g, "global_over_smem": g / s, "bits_equal": same}
    return res


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("p1_step_ab: no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy
    from sde4mbrl_px4_tpu_torch.ops.cuda import build

    with ThreadPoolExecutor(2) as ex:
        list(ex.map(build.build_library, ("apg_solve_p1", "cost_oracle")))
    apply_fp32_policy()
    dev = torch.device("cuda")
    for hid in HIDS:
        print("P1_STEP_AB " + json.dumps({"hidden": hid, **measure(cs, hid, dev)}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

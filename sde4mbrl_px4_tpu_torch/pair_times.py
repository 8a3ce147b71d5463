"""Kernel and route times of the PyTorch/CUDA port, checkout against checkout,
on one card.

    python3 sde4mbrl_px4_tpu_torch/pair_times.py [--routes | --wide | --gw] ROOT [ROOT ...]

Each ROOT is a checkout of this repository: this one, or another commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each runs in a fresh process, in the order given (for two commits give
parent, change, change, parent), and builds its own kernels. Each process
uses its own checkout's ``chip_smoke.py`` helpers, so both sides solve the
same problems on the same seeds. It prints one line ``PAIR_TIMES {json}``
per ROOT, then the card's name and power limit:

- per-launch device times (CUDA events) of the oracle kernels at P=1
  (``value_batch`` K=64, ``value_and_grad``, ``trajectory``; both
  state-constraint forms), at P=512 antithetic (``value_batch`` K=1 and
  K=4, ``value_and_grad``) and at the P=128 altitude floor;
- the fixed-budget whole solves of ``chip_smoke.py`` (traj 10 iterations,
  each constraint form 10, P=512 antithetic 5, with its ``trajectory``);
- wall times of the host-bound oracle routes through ``mpc_fn``: MPPI
  (p50 over ticks 3-10) and fixed-step APG at P=1 and at P=512 antithetic
  (the route of ``chip_smoke.py`` phase 13 at ``matmul_precision:
  highest``, the fp32 forms: iterations, ms per iteration, each solve's
  u0);
- outputs whose bits the checkouts are compared on (keys ending in
  ``_bits``): ``value_batch`` at P=512 antithetic (24 plans, K=4) and at
  the P=128 floor (16 plans, K=1), the u0 of the P=512 route's first
  solve, ``value_batch`` K=1 on an ill-conditioned trunk (below), and the
  particle options' forms at P=512 antithetic with ``risk_lambda`` 2 and
  the example's starts, fp32 and bf16 (``value_batch`` K=4 on 8 plans,
  ``value_and_grad`` on 4, the whole solve's plan at a fixed 5
  iterations). The
  last line before the card's says, per such key, whether every ROOT gave
  the same bits;
- the ill-conditioned trunk: 48 random hidden units (``init_params``, seed
  48) with the output layer scaled by 100, whose rollout reaches a cost of
  ~6.5e13. Its ``value_batch`` K=1 on the kernel (the shared-memory step)
  beside the plain oracle in float32 and in float64, and the spread of the
  float32 plain value over 8 orders of the hidden units (the same
  function): how far summation order alone moves this cost.

With ``--wide`` only the P=1 whole solve and ``value_and_grad`` on trunks
off the register chain's widths are timed (:func:`measure_wide`: the
flagship's chained and cold solves at 128 and 256 units, a fixed
10-iteration solve, each oracle kernel per launch, the fixed-step route),
which needs only the libraries of those forms.

With ``--gw`` only the particle global-weight oracle on the 256-unit
trunk and ``trajectory`` on wide trunks are timed (:func:`measure_gw`: the
launches whose particle chunk the oracle plans by the spread, and the
trajectory kernel's sums), which needs only the oracle's and the whole
solve's libraries.

With ``--routes`` only the two host-bound P=1 routes are timed, MPPI and
fixed-step APG through ``mpc_fn``, over 30 chained solves each (p50 and
min over ticks 3-30), which needs only the oracle's library; beside each,
what one chained solve dispatches (:func:`dispatch_counts`): its tensor
ops that run a kernel, its host reads of a device value, and its oracle
kernel launches; and where the host's time in such a solve goes
(:func:`host_profile`).

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def ill_conditioned_trunk(cs, CO, dev) -> dict:
    """``value_batch`` K=1 on the 48-unit trunk of the module docstring:
    the kernel, the plain oracle in float32 and float64, and the float32
    plain values over 8 orders of the hidden units."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.cost.cost import make_cost_fn
    from sde4mbrl_px4_tpu_torch.models.sde_model import init_params
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_sde

    b = cs.make_bundle("iris_posctrl_mpc", dev)
    x0, x_ref, u_prev, _ = cs.problem(b, dev)
    net = init_params(torch.Generator().manual_seed(48), b.model, hidden=48, device=dev)["net"]
    net["w2"] = net["w2"] * 100
    U = cs.plans(1, 1, dev)

    def oracle(params, plain):
        make = CO.cost_oracle_plain if plain else CO.cost_oracle
        return make(b.model, params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1, 4)

    out = {"trunk48_kernel": float(oracle(dict(b.params, net=net), False).value_batch(U)[0]),
           "trunk48_plain": float(oracle(dict(b.params, net=net), True).value_batch(U)[0])}

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() else t

    params = {k: ({n: f64(w) for n, w in v.items()} if isinstance(v, dict) else f64(v))
              for k, v in dict(b.params, net=net).items()}
    cp = b.cost_params._replace(**{k: f64(v) for k, v in b.cost_params._asdict().items()})
    ts, n_u = b.time_steps.double(), b.model.n_u
    xp, sg = rollout_sde(b.model, params, f64(x0), f64(U[0]), ts,
                         torch.zeros((ts.shape[0], 1, 13), dtype=torch.float64, device=dev))
    out["trunk48_plain_float64"] = float(make_cost_fn(cp, ts)(
        xp, sg, f64(U[0]), f64(x_ref), f64(u_prev)[:n_u], None))
    orders = []
    for s in range(8):
        p0, p1 = (torch.from_numpy(np.random.RandomState(s + k).permutation(48)).to(dev)
                  for k in (0, 100))
        perm = dict(net, w0=net["w0"][:, p0], b0=net["b0"][p0], w1=net["w1"][p0][:, p1],
                    b1=net["b1"][p1], w2=net["w2"][p1])
        orders.append(float(oracle(dict(b.params, net=perm), True).value_batch(U)[0]))
    out["trunk48_plain_orders"] = orders
    out["trunk48_kernel_bits"] = out["trunk48_kernel"]
    return out


# dispatcher ops that launch no kernel (views, allocations, host scalars)
_NO_KERNEL = ("view", "_unsafe_view", "unsqueeze", "squeeze", "select", "slice", "expand",
              "as_strided", "alias", "t", "transpose", "permute", "detach", "empty",
              "empty_strided", "empty_like", "scalar_tensor", "lift_fresh", "unbind",
              "split", "split_with_sizes", "_reshape_alias", "reshape", "unflatten",
              "flatten", "_local_scalar_dense")


def dispatch_counts(cs, cfg, dev) -> dict:
    """What the third of three chained solves of ``cfg`` dispatches: tensor
    ops that run a kernel (every dispatcher op but views, allocations and
    host scalars), host reads of a device value (``_local_scalar_dense``),
    and oracle kernel launches (the wrappers' counters)."""
    import collections
    import copy

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    ops = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    def make(c, d):
        c, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(c), device=d)
        n = [0]

        def mpc(*a, **kw):
            n[0] += 1
            if n[0] != 3:
                return mpc_fn(*a, **kw)
            cs.zero_counts()
            with Count():
                return mpc_fn(*a, **kw)

        return c, (reset_fn, mpc), sft, b

    cs.chain(cfg, dev, 3, make)
    torch.cuda.synchronize()
    return {"kernel_ops": sum(v for k, v in ops.items() if k not in _NO_KERNEL),
            "host_reads": ops["_local_scalar_dense"],
            "oracle_launches": sum(cs.counts().values())}


def host_profile(cs, cfg, dev, top: int = 14) -> list:
    """The host's time in the third of three chained solves of ``cfg``
    (``torch.profiler``, host activity only): the ``top`` entries by self
    time, as ``[name, calls, self us]``, and the solve's total."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    box = {}

    def make(c, d):
        c, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(c), device=d)
        n = [0]

        def mpc(*a, **kw):
            n[0] += 1
            if n[0] != 3:
                return mpc_fn(*a, **kw)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = mpc_fn(*a, **kw)
                out[0].cpu()
            box["prof"] = prof
            return out

        return c, (reset_fn, mpc), sft, b

    cs.chain(cfg, dev, 3, make)
    torch.cuda.synchronize()
    rows = sorted(box["prof"].key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in rows)
    return ([["total", 0, round(total, 1)]]
            + [[e.key, e.count, round(e.self_cpu_time_total, 1)] for e in rows[:top]])


GW_TRAJECTORY_HIDS = (128, 256, 1024)
GW_ROUTE_REPS = 3


def measure_gw(cs, dev) -> dict:
    """One checkout's particle global-weight oracle on the 256-unit
    checkpoint (``chip_smoke.py::wide_checkpoint``) and its ``trajectory``
    on wide trunks: MPPI over ``MPPI_K`` x ``MPPI_P`` antithetic paths
    through ``mpc_fn`` (phase 30 (i)'s route: its checks, two chained
    solves' wall ms; then 8 chained solves, wall ms p50 over solves 3-8, the
    first solve's plan) and its ``value_batch`` at K = ``MPPI_K`` and 1 per
    launch (CUDA events; the oracle planned as the route plans it); the
    particle-sharded P_FULL solve over mc = 2 with risk and starts (phase 30
    (i): ms an iteration by rank) and its moments-out ``value_batch`` at K =
    1 and 4 per launch on one rank's P_FULL / 2 particles, bits at K = 4;
    the fixed-step P_FULL route (bf16), GW_ROUTE_REPS runs of two chained
    solves (the second's wall ms an iteration); ``value_batch`` K = 1 and
    ``value_and_grad`` per launch at P_FULL (bf16); ``trajectory`` per
    launch at P=1 on each of GW_TRAJECTORY_HIDS units, its bits."""
    import inspect
    import tempfile

    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    card = cs.card_line()
    out = {}
    # the oracle as the loader plans it for MPPI (a checkout without the
    # argument plans every oracle alike)
    mppi_plans = ({"plans": cs.MPPI_K}
                  if "plans" in inspect.signature(CO.cost_oracle).parameters else {})
    tb = cs.make_bundle("iris_traj_mpc", dev)
    with tempfile.TemporaryDirectory(prefix="pair_times_gw_") as td:
        ckpt = cs.wide_checkpoint(td, tb, 256)
        out["mppi_route_wall_ms"] = cs.unflown_mppi(dev, ckpt, card)["wall_ms"]
        mcfg = cs.wide_config("iris_posctrl_mpc", ckpt, solver="mppi", particles=cs.MPPI_P,
                              mppi={"samples": cs.MPPI_K, "iters": 8})
        rows, ms = cs.chain(mcfg, dev, 8)
        out["mppi_route_ms_p50"] = statistics.median(ms[2:])
        out["mppi_route_u0_bits"] = rows[0, :-1].tolist()
        ob = make_mpc_from_config(cs.wide_config("iris_posctrl_mpc", ckpt), device=dev)[3]
        x0, x_ref, u_prev, _ = cs.problem(ob, dev)
        zm = cs.brownian(cs.MPPI_P, dev, antithetic=True, seed=0)
        o = CO.cost_oracle(ob.model, ob.params, ob.cost_params, ob.time_steps, x0, x_ref,
                           u_prev, zm, cs.MPPI_P, 4, **mppi_plans)
        Um = cs.plans(cs.MPPI_K, 21, dev)
        out["mppi_value_batch_K64_ms"] = cs.per_launch_ms(lambda: o.value_batch(Um), 20)
        out["mppi_value_batch_K1_ms"] = cs.per_launch_ms(lambda: o.value_batch(Um[:1]), 20)
        out["mppi_value_batch_bits"] = o.value_batch(Um).tolist()

        out["mesh"] = cs.unflown_mesh(dev, ckpt, card)
        tcfg = cs.wide_config("iris_traj_mpc", ckpt, particles=cs.P_FULL)
        tcfg["cost_params"]["risk_lambda"] = cs.RISK
        bt = make_mpc_from_config(tcfg, device=dev)[3]
        y0, y_ref, v_prev, _ = cs.problem(bt, dev)
        half = cs.P_FULL // 2
        zh = cs.brownian(half, dev, antithetic=True, seed=0)
        ob2 = CO.cost_oracle_batched(bt.model, bt.params, bt.cost_params, bt.time_steps,
                                     y0[None], y_ref[None], v_prev[None],
                                     zh[None].contiguous(), half, 4)
        U4 = cs.plans(4, 22, dev)[None].contiguous()
        out["mesh_moments_out_K1_ms"] = cs.per_launch_ms(
            lambda: ob2.value_batch_moments(U4[:, :1].contiguous()), 20)
        out["mesh_moments_out_K4_ms"] = cs.per_launch_ms(lambda: ob2.value_batch_moments(U4), 20)
        out["mesh_moments_out_K4_bits"] = ob2.value_batch_moments(U4).tolist()

        scfg = cs.config("iris_posctrl_mpc", particles=cs.P_FULL, linesearch=None,
                         stepsize=cs.FIXED_STEP["iris_posctrl_mpc"])
        scfg["learned_model_params"] = ckpt
        its = []
        for _ in range(GW_ROUTE_REPS):
            rows, ms = cs.chain(scfg, dev, 2)
            its.append(ms[1] / max(int(rows[1, -1]), 1))
        out["fixed_step_p512_iteration_ms"] = its
        bp = make_mpc_from_config(cs.wide_config("iris_posctrl_mpc", ckpt), device=dev)[3]
        p0, pr, pu, _ = cs.problem(bp, dev)
        z512 = cs.brownian(cs.P_FULL, dev, antithetic=True, seed=0)
        o = CO.cost_oracle(bp.model, bp.params, bp.cost_params, bp.time_steps, p0, pr, pu, z512,
                           cs.P_FULL, 4, bf16=True)
        U1, u = cs.plans(1, 23, dev), cs.plans(1, 24, dev)[0]
        out["p512_value_batch_K1_bf16_ms"] = cs.per_launch_ms(lambda: o.value_batch(U1), 20)
        out["p512_value_and_grad_bf16_ms"] = cs.per_launch_ms(lambda: o.value_and_grad(u), 20)

        for hid in GW_TRAJECTORY_HIDS:
            ck = ckpt if hid == 256 else cs.wide_checkpoint(td, tb, hid)
            b = make_mpc_from_config(cs.wide_config("iris_posctrl_mpc", ck), device=dev)[3]
            q0, qr, qu, _ = cs.problem(b, dev)
            o = CO.cost_oracle(b.model, b.params, b.cost_params, b.time_steps, q0, qr, qu, None,
                               1, 4)
            ut = cs.plans(1, 25, dev)[0]
            out[f"h{hid}_trajectory_ms"] = cs.per_launch_ms(lambda: o.trajectory(ut), 50)
            out[f"h{hid}_trajectory_bits"] = o.trajectory(ut).reshape(-1).tolist()
    return out


WIDE_HIDS = (128, 256)   # the weights in shared memory; in device memory
WIDE_SOLVES, WIDE_COLD = 12, 200


def measure_wide(cs, dev) -> dict:
    """The P=1 whole solve and ``value_and_grad`` of one checkout on the
    iris trunk at each of WIDE_HIDS units (``chip_smoke.py::wide_checkpoint``):
    the shipped traj config through ``mpc_fn``, WIDE_SOLVES chained solves
    along the lemniscate (device ms a solve by CUDA events, iterations, ms an
    iteration p50 over solves 2-12, the plans' bits); ``problem``'s plan at a
    fixed WIDE_COLD iterations (the cold solve) and at a fixed 10 (mean of
    3 and of 10); on the posctrl config ``value_and_grad``, ``value_batch``
    K = 1 and ``trajectory`` per launch, whether ``value_batch`` K = 1 gives
    ``value_and_grad``'s value bit for bit, and the fixed-step route's 3
    chained solves (wall ms, iterations, plans)."""
    import tempfile

    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    out = {}
    tb = cs.make_bundle("iris_traj_mpc", dev)
    with tempfile.TemporaryDirectory(prefix="pair_times_wide_") as td:
        for hid in WIDE_HIDS:
            tag = f"h{hid}_"
            ckpt = cs.wide_checkpoint(td, tb, hid)
            cfg, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(
                cs.wide_config("iris_traj_mpc", ckpt), device=dev)
            dt, x = float(cfg["_time_steps"][0]), enu2ned(sft(np.float32(3.0)))
            st, events, steps, plans = reset_fn(x, None, x), [], [], []
            with cs.routed("apg_solve_kernel", cs.event_timed(events)):
                for k in range(WIDE_SOLVES):
                    u, st, _, x_evol = mpc_fn(x, None, st, np.float32(3.0 + k * dt), x)
                    steps.append(int(st.num_steps))
                    plans.append(u[0].tolist())
                    x = x_evol[1]
            torch.cuda.synchronize()
            ms = [a.elapsed_time(e) for a, e in events]
            out.update({tag + "flagship_ms": ms, tag + "flagship_steps": steps,
                        tag + "flagship_u0_bits": plans,
                        tag + "iteration_ms": statistics.median(
                            d / n for d, n in zip(ms[1:], steps[1:]))})
            x0, x_ref, u_prev, u_init = cs.problem(b, dev)
            for iters, n, key in ((WIDE_COLD, 3, "cold"), (10, 10, "fixed10")):
                apg = b.apg_config._replace(max_iter=iters, max_no_improvement_iter=iters,
                                            atol=0.0, rtol=0.0)
                args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev,
                        None, 1, b.lb, b.ub, u_init)
                out[tag + key + "_ms"] = cs.time_fixed(AK, args, b.precond, n_kernel=n,
                                                       n_plain=0)[0]
                sol = AK.apg_solve_kernel(*args, precond=b.precond)[0]
                out[tag + key + "_steps"] = int(sol.num_steps)
                out[tag + key + "_bits"] = sol.yk.reshape(-1).tolist()
            ob = make_mpc_from_config(cs.wide_config("iris_posctrl_mpc", ckpt), device=dev)[3]
            y0, y_ref, v_prev, _ = cs.problem(ob, dev)
            o = CO.cost_oracle(ob.model, ob.params, ob.cost_params, ob.time_steps, y0, y_ref,
                               v_prev, None, 1, 4)
            u1 = cs.plans(1, 2, dev)[0]
            out[tag + "value_and_grad_ms"] = cs.per_launch_ms(lambda: o.value_and_grad(u1), 100)
            out[tag + "value_batch_K1_ms"] = cs.per_launch_ms(lambda: o.value_batch(u1[None]), 100)
            out[tag + "trajectory_ms"] = cs.per_launch_ms(lambda: o.trajectory(u1), 100)
            v, g = o.value_and_grad(u1)
            out[tag + "value_and_grad_bits"] = [float(v)] + g.reshape(-1).tolist()
            out[tag + "value_batch_equals_value_and_grad"] = bool(
                torch.equal(o.value_batch(u1[None])[0], v))
            rows, ms = cs.chain(cs.wide_config("iris_posctrl_mpc", ckpt, linesearch=None,
                                               stepsize=cs.FIXED_STEP["iris_posctrl_mpc"]),
                                dev, 3)
            out.update({tag + "fixed_step_ms": ms, tag + "fixed_step_iterations":
                        rows[:, -1].tolist(), tag + "fixed_step_u0_bits": rows[:, :-1].tolist()})
    return out


def measure(root: str, routes: bool = False, wide: bool = False, gw: bool = False) -> dict:
    """The times of one checkout, in this process (its package and
    ``chip_smoke.py`` first on ``sys.path``, this file's directory off it);
    with ``routes`` only the P=1 routes' wall times, with ``wide``
    :func:`measure_wide`, with ``gw`` :func:`measure_gw`."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy
    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    if not torch.cuda.is_available():
        raise SystemExit("pair_times: no CUDA device")
    apply_fp32_policy()
    dev = torch.device("cuda")
    out = {"root": root}

    if wide:
        out.update(measure_wide(cs, dev))
        return out
    if gw:
        out.update(measure_gw(cs, dev))
        return out
    if routes:
        step = cs.FIXED_STEP["iris_posctrl_mpc"]
        for key, cfg in (("mppi", cs.config("iris_posctrl_mpc", solver="mppi")),
                         ("fixed_step", cs.config("iris_posctrl_mpc", linesearch=None,
                                                  stepsize=step))):
            rows, ms = cs.chain(cfg, dev, 30)
            out[f"{key}_ms_p50"] = statistics.median(ms[2:])
            out[f"{key}_ms_min"] = min(ms[2:])
            out[f"{key}_iterations"] = rows[2:, -1].tolist()
            out[f"{key}_dispatch"] = dispatch_counts(cs, cfg, dev)
            out[f"{key}_host_profile"] = host_profile(cs, cfg, dev)
        return out

    def fixed(b, apg, x0, x_ref, u_prev, z, P, lb, ub, u_init, pre=None, n=20):
        args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, z, P,
                lb, ub, u_init)
        return cs.time_fixed(AK, args, pre, n_kernel=n, n_plain=0)[0]

    b = cs.make_bundle("iris_traj_mpc", dev)
    x0, x_ref, u_prev, u_init = cs.problem(b, dev)
    out["apg_traj_fixed10"] = fixed(b, b.apg_config._replace(
        max_iter=10, max_no_improvement_iter=10), x0, x_ref, u_prev, None, 1, b.lb, b.ub, u_init)
    z512 = cs.brownian(512, dev, antithetic=True, seed=0)
    out["apg_p512_fixed5"] = fixed(b, b.apg_config._replace(
        max_iter=5, max_no_improvement_iter=5), x0, x_ref, u_prev, z512, 512, b.lb, b.ub,
        u_init, b.precond, n=5)
    for form in cs.SC_FORMS:
        bc = make_mpc_from_config(cs.constrained_config(form), device=dev)[3]
        cx0, cxr, cup, z_init = constrained_problem(bc)
        out[f"apg_{form}_fixed10"] = fixed(bc, bc.apg_config._replace(
            max_iter=10, max_no_improvement_iter=10), cx0, cxr, cup, None, 1, bc.lb_z, bc.ub_z,
            z_init)
        o = CO.cost_oracle(bc.model, bc.params, bc.cost_params, bc.time_steps, cx0, cxr, cup,
                           None, 1, 4)
        U, u = constrained_plans(bc, 64, 1), constrained_plans(bc, 1, 2)[0]
        out[f"value_and_grad_{form}"] = cs.per_launch_ms(lambda: o.value_and_grad(u), 50)
        out[f"value_batch_K64_{form}"] = cs.per_launch_ms(lambda: o.value_batch(U), 50)

    _, o, _ = cs.oracles("iris_posctrl_mpc", dev)
    U, u = cs.plans(64, 1, dev), cs.plans(1, 2, dev)[0]
    out["value_and_grad"] = cs.per_launch_ms(lambda: o.value_and_grad(u), 50)
    out["value_batch_K64"] = cs.per_launch_ms(lambda: o.value_batch(U), 50)
    out["trajectory"] = cs.per_launch_ms(lambda: o.trajectory(u), 50)
    bp = cs.make_bundle("iris_posctrl_mpc", dev)
    px0, pxr, pup, _ = cs.problem(bp, dev)
    o = CO.cost_oracle(bp.model, bp.params, bp.cost_params, bp.time_steps, px0, pxr, pup,
                       z512, 512, 4)
    U4, u = cs.plans(4, 3, dev), cs.plans(1, 4, dev)[0]
    out["value_and_grad_p512"] = cs.per_launch_ms(lambda: o.value_and_grad(u), 20)
    out["value_batch_p512_K1"] = cs.per_launch_ms(lambda: o.value_batch(U4[:1]), 20)
    out["value_batch_p512_K4"] = cs.per_launch_ms(lambda: o.value_batch(U4), 20)
    out["value_batch_p512_bits"] = [o.value_batch(cs.plans(4, s, dev)).tolist()
                                    for s in range(24)]
    bf = cs.floor_mpc(cs.floor_config(), dev)[3]
    fx0, fxr, fup, _ = constrained_problem(bf)
    o = CO.cost_oracle(bf.model, bf.params, bf.cost_params, bf.time_steps, fx0, fxr, fup,
                       cs.brownian(128, dev, antithetic=True, seed=2), 128, 4)
    out["value_batch_floor_K1"] = cs.per_launch_ms(lambda: o.value_batch(U4[:1]), 20)
    out["value_batch_floor_bits"] = [o.value_batch(cs.plans(1, 200 + s, dev)).tolist()
                                     for s in range(16)]
    out["value_and_grad_floor"] = cs.per_launch_ms(lambda: o.value_and_grad(u), 20)
    # the particle options' forms (risk and starts), fp32 and bf16
    cp, starts = cs.with_options(bp, ("risk", "starts"), px0, 512, dev, seed=512)
    apg = bp.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    for bf in (False, True):
        tag = "bf16" if bf else "fp32"
        o = CO.cost_oracle(bp.model, bp.params, cp, bp.time_steps, px0, pxr, pup, z512, 512, 4,
                           starts=starts, bf16=bf)
        out[f"options_{tag}_value_batch_bits"] = [o.value_batch(cs.plans(4, 300 + s, dev))
                                                  .tolist() for s in range(8)]
        vg = [o.value_and_grad(cs.plans(1, 400 + s, dev)[0]) for s in range(4)]
        out[f"options_{tag}_value_and_grad_bits"] = [[float(v)] + g.reshape(-1).tolist()
                                                     for v, g in vg]
        st, _ = AK.apg_solve_kernel(bp.model, bp.params, cp, apg, bp.time_steps, px0, pxr, pup,
                                    z512, 512, bp.lb, bp.ub, cs.plans(1, 5, dev)[0],
                                    starts=starts, bf16=bf)
        out[f"options_{tag}_apg_solve_bits"] = st.yk.reshape(-1).tolist()

    _, ms = cs.chain(cs.config("iris_posctrl_mpc", solver="mppi"), dev, 10)
    out["mppi_ms_p50"] = statistics.median(ms[2:])
    step = cs.FIXED_STEP["iris_posctrl_mpc"]
    rows, ms = cs.chain(cs.config("iris_posctrl_mpc", linesearch=None, stepsize=step), dev, 4)
    out["fixed_step_ms_p50"] = statistics.median(ms[1:])
    out["fixed_step_iterations"] = rows[:, -1].tolist()
    cfg = cs.config("iris_posctrl_mpc", linesearch=None, stepsize=step, particles=512)
    cfg["matmul_precision"] = "highest"       # the fp32 forms (a checkout's default may not be)
    for rep in range(2):                      # phase 13's route, twice
        rows, ms = cs.chain(cfg, dev, 2)
        out[f"fixed_step_p512_iterations_{rep}"] = rows[:, -1].tolist()
        out[f"fixed_step_p512_iteration_ms_{rep}"] = [m / k for m, k in zip(ms, rows[:, -1])]
        out[f"fixed_step_p512_u0_{rep}"] = rows[:, :-1].tolist()
    out["fixed_step_p512_first_u0_bits"] = rows[0, :-1].tolist()
    out.update(ill_conditioned_trunk(cs, CO, dev))
    return out


def main() -> int:
    argv = sys.argv[1:]
    routes, wide, gw = "--routes" in argv, "--wide" in argv, "--gw" in argv
    argv = [a for a in argv if a not in ("--routes", "--wide", "--gw")]
    if len(argv) > 1 and argv[0] == "--one":
        print("PAIR_TIMES " + json.dumps(measure(os.path.abspath(argv[1]), routes, wide, gw)),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                           + ["--routes"] * routes + ["--wide"] * wide + ["--gw"] * gw,
                           stdout=subprocess.PIPE, text=True)
        print(r.stdout, end="", flush=True)
        if r.returncode != 0:
            return r.returncode
        line = [x for x in r.stdout.splitlines() if x.startswith("PAIR_TIMES ")][-1]
        runs.append(json.loads(line[len("PAIR_TIMES "):]))
    print("BITS " + json.dumps({k: all(run[k] == runs[0][k] for run in runs)
                                for k in runs[0] if k.endswith("_bits")}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

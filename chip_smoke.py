"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three solve routes through ``mpc_fn`` on the card and
checks them: the linesearch APG on the hand-written whole-solve kernel
(flown by ``RecedingHorizonController`` on both iris flight configs and
both hexa ones), and MPPI and fixed-step APG on the hand-written
cost-oracle kernels; then flies the closed loop (the engine node on the
card against the simulated FCU over UDP) and the two-process launch tier.
Phases
(each prints a line; any failure raises and the script exits non-zero
without a result):

1. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds both kernel libraries from ``sde4mbrl_px4_tpu_torch/csrc`` (one
   ``nvcc`` each, in parallel) and prints the build seconds and the
   compiler's register/spill/shared-memory summary per ``<PART, SC>`` form;
   fails if a P=1 form on the register chain (the whole solve,
   ``value_and_grad``, ``value_batch`` and ``trajectory``: their trunk lives
   in registers) or a cluster form of ``value_batch`` spills; prints the
   registers and spills of the cluster particle forms and of the
   shared-memory step of ``value_batch`` and ``trajectory``; builds the
   host runtime ``csrc/libmpc_native.so`` (``make -C csrc``: the native
   mailbox) beside them; prints the P=1 forms' shared memory at n_u = 4
   (iris) and n_u = 6 (hexa) and fails if the whole solve's passes 48 KB;
3. holds the whole-solve kernel against its plain PyTorch version: the
   fixed-budget solves of the CPU tests (traj max_iter=10 at rtol 2e-4 /
   atol 2e-5, posctrl max_iter=8 at rtol 5e-4 / atol 5e-5, plus the traj
   solve with its hover_diag metric), equal iteration counts, and
   ``x_evol`` against the mean rollout of the kernel's plan (rtol 1e-5);
4. holds each cost-oracle kernel against the plain oracle on both iris
   configs: ``value_batch`` at K = 1, 4, 9, 17, 64, 256 (rtol 2e-5; 8
   candidates per block), ``value_and_grad`` (rtol 5e-4 / atol 5e-5),
   ``trajectory`` (rtol 1e-5); then ``value_batch`` (K = 1, 20, 64) and
   ``trajectory`` on the trunk padded to 72 units, outside the register
   layout (``goldens.padded_trunk``: 8 new units drawn like the shipped
   ones, which move the costs ~1e-3 relative); the rows
   per ``value_batch`` block against ``consts.value_batch_grid``;
5. runs fixed-step APG (the configs without a linesearch block) over the
   kernel oracle and over the plain one at a fixed budget: equal
   iteration counts, rtol 2e-4 / atol 2e-5;
6. the whole-solve route: a controller per replay on ``cuda`` replays
   ``replay_pos``, ``replay_traj`` and the 42-tick ``replay_engagement``
   against the committed iris goldens at the gates of ``bench.py:250``
   (the engagement's cost is printed, not gated: see ``phase_slice``);
7. the MPPI route: ``replay_solver_family("mppi")`` (4 solves, K=64,
   8 rounds) through the kernels and through the plain oracle with the
   same generator draws (|du| <= 1e-4 per row, equal step counts), then
   the 30-tick position step of ``tests/test_mppi.py:48-76`` at K=256
   through the kernels (the gap must close to below 0.35 of its start);
8. the fixed-step route: chained solves of the posctrl config without
   its linesearch block through the kernels;
9. times, on the same card, kernel against plain: the chained pos and
   traj replays per solve (p50, wall clock from dispatch to the plan on
   the host; device span per APG iteration), MPPI and fixed-step APG per
   solve (p50 over chained ticks; the plain replays and fixed-step route
   time their first tick only), and each oracle kernel per launch (CUDA
   events); then the whole-solve kernel's phase split on a traj replay
   tick (``phase_split``: its clock-stamped instantiation);
10. Monte-Carlo particles, kernel against plain on the same torch draws,
    both iris configs, at P=8 (one chunk), P=64 in chunks of 16, P=96 in
    chunks of 32 (a cluster of 3 blocks) and P=1024 antithetic (32 chunks,
    2 per block): the noise and chunk branches of ``value`` and
    ``value_batch`` (K=4, rtol 2e-5) and ``value_and_grad`` (value rtol
    2e-5, gradient rtol 5e-4 / atol 5e-5), and the particle form of the
    whole solve at max_iter=10 (equal steps, ``yk`` rtol 5e-4 / atol 5e-5,
    ``opt_cost`` rel 5e-4, as ``tests/test_apg_kernel.py:100-105``;
    ``x_evol`` the mean rollout of the plan); ``value_and_grad`` and the
    solve on their cluster against one block (``cluster=1``) within 1e-6,
    equal steps (equal bits expected), ``value_batch`` (K = 4, 9) on its
    grid of clusters against one block per candidate with equal bits;
11. the ``p512anti`` solver family (4 solves, max_iter 6, P=512
    antithetic) through the kernels and through the plain version with the
    same draws: |du| <= 5e-4, the golden's own tolerance, equal steps;
12. the full-width particle route: ``iris_traj_mpc.yaml`` at P=512
    antithetic, max_iter 200, chained through ``mpc_fn`` along the
    lemniscate (per-solve p50, iterations, per-iteration time, tracking
    error of ``x_evol[1]``), then three traj ticks of a
    ``RecedingHorizonController`` flying that config; a fixed 5-iteration
    P=512 solve, kernel against plain (parity and times) and at its cluster
    against C = 1 (equal steps, max|du| and the ``opt_cost`` gap within
    1e-6; C, C_max, the chunks per block and
    ``cudaOccupancyMaxActiveClusters`` printed); its phase split
    (``particle_phase_split``: the clock-stamped particle instantiation on
    cluster ranks 0 and 15); the chosen chunk and shared memory;
13. the fixed-step route at P=512 antithetic (the posctrl config without
    its linesearch block) on the oracle kernels' particle branches, its
    iterations and wall time per iteration; then those kernels
    against the plain oracle at P=512 in the route's chunks (``value`` at
    K=1 and ``value_batch`` at K=4, rtol 2e-5; ``value_and_grad``, value
    rtol 2e-5, gradient rtol 5e-4 / atol 5e-5), ``value_batch`` at K=1 and
    K=4 against C = 1 (equal bits), and their per-launch times, each also
    at C = 1;
14. state constraints (``state_constr``), kernel against plain, on
    ``configs/iris_constr_posctrl_mpc.yaml`` as shipped (proximal slack,
    nZ = 10) and in its penalty form, each at P=1 and at P=8 in chunks of
    4: the whole solve at max_iter=10 from a bound-violating start (the
    particle tolerances), ``value``/``value_batch`` (K = 4, 64, 256) and
    ``value_and_grad`` at the oracle tolerances, ``value_batch`` at P=8
    against C = 1 (equal bits), ``trajectory`` of an nZ-wide plan; then
    the altitude floor of ``examples/noise_robustness.py`` (penalty form)
    at P=128 antithetic, a fixed 5-iteration solve, timed, and its oracle
    against plain and ``value_batch`` against C = 1; each form's shared
    memory;
15. the constrained flight of ``examples/constrained_mpc.py``: 100 chained
    ticks of the 3 m step without the block, with it (gate: the example's
    own, v_c < v_u and v_c < 0.75 m/s) and in its penalty form, one
    ``apg_solve`` launch per tick and no ``trajectory``; the shipped config
    as a controller's position config; the floor route at P=128 through
    ``mpc_fn``; the fixed 10-iteration solve of each form, kernel against
    plain, timed;
16. the oracle routes with constraints, in both forms: MPPI at the
    ``MPPIConfig`` defaults through the kernels and through the plain
    oracle with the same draws (|du| <= 1e-4 per row), fixed-step APG
    (kernel oracle against plain in lockstep), per-launch times at nZ = 10
    and nZ = 4; the fixed-step floor route at P=128 and its oracle kernels
    against plain;
17. the hexa airframe (n_u = 6, F = 15): the oracle kernels against plain
    at the phase-4 tolerances (``value_batch`` K = 1, 9, 64 on the register
    chain, ``value_and_grad``, ``trajectory``), the fixed 10-iteration
    traj solve (phase 3's check), the fixed 5-iteration P=512 antithetic
    solve with its ``trajectory`` launch (the particle tolerances; its
    ``x_evol`` held to the float64 rollout within rtol 1e-5 / atol 1e-6
    plus twice the float32 spread of the plain rollout, ``rollout_spread``:
    near hover the hexa's six-motor torque sums cancel, and float32
    rollouts of that plan scatter by ~3e-6 with the summation order), the
    three hexa goldens
    (the engagement's commands gated from tick 20 on, its cost printed;
    see ``goldens.ENGAGEMENT_GATED_FROM``) with their launch counts, and
    the chained hexa pos and traj replays' per-solve wall time p50 and
    iterations;
18. the closed loop, ``sde4mbrl_px4_tpu_torch/sim/closed_loop.py`` with
    the engine on the card and the pipeline on, 6 s at time-scale 1 each:
    iris and hexa (gate: mean tracking error < 0.35 m over t_traj > 3 s,
    FCU ``MPC_ON``), then iris at P=512 antithetic without and with
    ``--deadline-ms 30`` (printed, not gated);
    each prints its errors, watchdog trips, timeout ticks, largest pickup
    index, solve time p50, the ingress pick's p50 and p99, the mailbox and
    codec, and its kernel launches (zeroed before it, the engine's warm
    solves included: ``apg_solve`` only at P=1, ``trajectory`` too at
    P=512);
19. the launch tier: ``fcu_sim`` (iris) and ``sde_control`` as two fresh
    ``python -m sde4mbrl_px4_tpu_torch.launch`` processes on free ports;
    gates: READY from both within 300 s, the FCU at ``MPC_ON`` within 30 s
    of ``initialize_mpc`` and the traj idle mode set over
    ``EngineServiceClient``, the traj mode reported 3 s after
    ``CTRL_TRAJ_ACTIVE`` with the FCU still on, both exiting 0 on SIGTERM.

In phases 6-8, 11-13 and 15-18 every kernel's launch count is set to 0 just
before the route runs and read just after: each route must have launched
exactly the kernels it is made of, as many times as its solves need (a
particle solve is one ``apg_solve`` and one ``trajectory`` launch), and
JAX must never be imported.

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
TOLS = {"iris_traj_mpc": (10, 2e-4, 2e-5), "iris_posctrl_mpc": (8, 5e-4, 5e-5)}
# fixed-step APG: a stepsize that accepts steps on the problem of each config
FIXED_STEP = {"iris_traj_mpc": 1e-3, "iris_posctrl_mpc": 1e-5}
LIBS = ("apg_solve", "cost_oracle")
# particle solves: yk rtol / atol, opt_cost rel (tests/test_apg_kernel.py:100-105)
PART_RTOL, PART_ATOL = 5e-4, 5e-5
P_FULL = 512      # the recommended flight operating point (bench.py:502-516)
# state constraints: the shipped proximal config and its penalty form
# (slack_proximal false); the kernels' forms as the build log names them
SHIPPED = "iris_constr_posctrl_mpc"
SC_FORMS = ("prox", "penalty")
SC_NAMES = ("none", "penalty", "prox")
FLIGHT_TICKS = 100   # examples/constrained_mpc.py: the 3 m step
P_FLOOR = 128        # examples/noise_robustness.py: P=128 antithetic, max_iter 60
# the trunk width of the shared-memory step checks: outside the P=1 register
# layout (64), and 16 value_batch rows of it still fit 48 KB
PADDED_HID = 72
FLOOR = {"state_id": [2], "state_bound": [[-5.0, -1.2]], "state_penalty": [300.0],
         "slack_scaling": [1.0]}   # its altitude floor (NED z <= -1.2), :125-130
FLOOR_NOISE = 0.6    # ... and the diffusion scale it gives the model (:102, :137)
VEHICLES = ("iris", "hexa")
# the hexa's fixed-budget solve: the CPU test's (tests/test_torch_hexa.py)
HEXA_TOLS = {"hexa_traj_mpc": (10, 2e-4, 2e-5)}
CLOSED_LOOP_S = 6.0    # seconds of each closed loop at time-scale 1
LAUNCH_READY_S, LAUNCH_ON_S = 300.0, 30.0   # the launch tier's time limits
# the least time of a call: the H100 SXM's fp32 rate outside the tensor cores
# and its HBM3 rate (NVIDIA's published H100 SXM figures)
PEAK_FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since start."""
    print(f"[chip_smoke {time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def config(name: str, **mut) -> dict:
    """An iris config, with ``solver``/``mppi`` set, the linesearch block
    deleted (``linesearch=None``), ``particles`` antithetic Monte-Carlo
    paths or the ``apg_mpc`` keys given."""
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(ROOT, f"configs/{name}.yaml"))
    for key in ("solver", "mppi"):
        if key in mut:
            cfg[key] = mut.pop(key)
    if "linesearch" in mut:
        mut.pop("linesearch")
        del cfg["apg_mpc"]["linesearch"]
    particles = mut.pop("particles", None)
    if particles:
        cfg.update(num_particles=particles, antithetic=True)
    cfg["apg_mpc"].update(mut)
    return cfg


def problem(b, dev):
    """The fixed-budget problem of the CPU parity tests."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    x0 = hover_state(dev)
    x0[0], x0[3] = 0.3, 0.2
    x_ref = hover_state(dev).expand(21, 13).contiguous()
    u_prev = b.cost_params.uref.clone()
    u_init = (u_prev.expand(20, b.model.n_u) + torch.tensor(0.02, device=dev)).contiguous()
    return x0, x_ref, u_prev, u_init


def counts() -> dict:
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    return {"apg_solve": AK.apg_solve_kernel.launches,
            "value_batch": CO.value_batch_kernel.launches,
            "value_and_grad": CO.value_and_grad_kernel.launches,
            "trajectory": CO.trajectory_kernel.launches}


def zero_counts() -> None:
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    for fn in (AK.apg_solve_kernel, CO.value_batch_kernel,
               CO.value_and_grad_kernel, CO.trajectory_kernel):
        fn.launches = 0


def check_route(name: str, expected: dict) -> dict:
    """The launch counts of a route just run against what it needs."""
    got = counts()
    log(f"kernel launches in the {name} route: {got} (expected {expected})")
    if got != expected or not any(got.values()):
        raise AssertionError(f"the {name} route did not launch the kernels it needs")
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    return got


def form_name(kernel: str, args: list) -> str:
    """An instantiation as the build log's mangled name gives it: ``kernel<PART,
    SC>`` plus the third flag (the whole solve's clock stamps, the P=1
    ``value_batch``'s register chain or shared-memory step); ``trajectory``'s
    one flag."""
    if kernel == "trajectory_kernel":
        return f"{kernel}<{'register chain' if args[0] else 'shared-memory step'}>"
    if len(args) < 2:
        return kernel
    extra = ""
    if len(args) > 2 and kernel == "apg_solve_kernel":
        extra = ", clock-stamped" if args[2] else ""
    elif len(args) > 2 and not args[0]:
        extra = ", register chain" if args[2] else ", shared-memory step"
    return f"{kernel}<{'true' if args[0] else 'false'}, {SC_NAMES[args[1]]}{extra}>"


def phase_build() -> None:
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import build
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    t = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS) + 1) as ex:
        # the host runtime (the native mailbox and MAVLink codec) the closed
        # loop runs on, built beside the kernels
        native = ex.submit(subprocess.run, ["make", "-C", os.path.join(ROOT, "csrc")],
                           capture_output=True, text=True, timeout=300)
        paths = dict(zip(LIBS, ex.map(build.build_library, LIBS)))
        native = native.result()
    nvcc_s = dict(build.build_library.seconds)     # loading reuses the builds
    if native.returncode != 0:
        raise AssertionError(f"make -C csrc failed: {native.stdout[-2000:]}"
                             f"{native.stderr[-2000:]}")
    log("phase 2: built csrc/libmpc_native.so (the native mailbox and MAVLink codec)")
    AK.load_apg_library()
    CO.load_oracle_library()
    log(f"phase 2: built {len(LIBS)} libraries in parallel in "
        f"{time.perf_counter() - t:.1f} s (with load)")
    spills, regs, current = {}, {}, None
    for name, path in paths.items():
        log(f"  {os.path.relpath(path, ROOT)}: nvcc {nvcc_s[name]:.1f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"entry function '.*\d([a-z_]+_kernel)(I(?:L[bi]\d+E)+E)?", line)
            if entry:
                args = [int(v) for v in re.findall(r"L[bi](\d+)E", entry.group(2) or "")]
                current = form_name(entry.group(1), args)
                log(f"  ptxas: {current}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
                stores = re.search(r"(\d+) bytes spill stores", line)
                if stores:
                    spills[current] = int(stores.group(1))
                used = re.search(r"Used (\d+) registers", line)
                if used:
                    regs[current] = int(used.group(1))
    p1 = {k: v for k, v in spills.items()
          if k.startswith(("apg_solve_kernel<false", "value_and_grad_kernel<false"))
          or "register chain" in k}
    log(f"  spill stores of the P=1 forms on the register chain: {p1}")
    part = {k: (regs.get(k), v) for k, v in spills.items()
            if k.startswith(("apg_solve_kernel<true", "value_and_grad_kernel<true",
                             "value_batch_kernel<true"))}
    log(f"  the cluster particle forms, (registers, spill stores in bytes): {part}")
    wide = {k: (regs.get(k), v) for k, v in spills.items() if "shared-memory step" in k}
    log(f"  the P=1 forms of value_batch and trajectory on the shared-memory step (trunks "
        f"outside the register layout), (registers, spill stores in bytes): {wide}")
    if len(p1) != 11 or any(p1.values()):
        raise AssertionError(f"a P=1 form on the register chain spills: {p1}")
    if len(part) != 10 or len(wide) != 4:
        raise AssertionError(f"the build log lacks a form: {part}, {wide}")
    vb = {k: v for k, v in part.items() if k.startswith("value_batch_kernel<true")}
    if any(v[1] for v in vb.values()):
        raise AssertionError(f"a cluster form of value_batch spills: {vb}")


def phase_parity(dev, tols: dict = TOLS) -> tuple:
    """Whole-solve kernel vs plain on the card, on the fixed-budget problem
    of each config of ``tols`` (name: (max_iter, rtol, atol)). Returns (max
    |du|, (kernel ms, plain ms) of the first config's solve)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    worst = 0.0
    timing = None
    for name, (max_iter, rtol, atol) in tols.items():
        b = load_mpc_from_cfgfile(os.path.join(ROOT, f"configs/{name}.yaml"), device=dev)[3]
        pres = [None] + ([b.precond] if b.precond is not None else [])
        for pre in pres:
            apg = b.apg_config._replace(max_iter=max_iter, max_no_improvement_iter=max_iter)
            x0, x_ref, u_prev, u_init = problem(b, dev)
            args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref,
                    u_prev, None, 1, b.lb, b.ub, u_init)
            st_k, xe_k = AK.apg_solve_kernel(*args, precond=pre)
            torch.cuda.synchronize()
            st_p, _ = AK.apg_solve_plain(*args, precond=pre)
            nk, np_ = int(st_k.num_steps), int(st_p.num_steps)
            du = float((st_k.yk - st_p.yk).abs().max())
            ok_u = bool(torch.allclose(st_k.yk, st_p.yk, rtol=rtol, atol=atol))
            dc = abs(float(st_k.opt_cost) - float(st_p.opt_cost)) / abs(float(st_p.opt_cost))
            ref = rollout_mean(b.model, b.params, x0, st_k.yk, b.time_steps)
            ok_x = bool(torch.allclose(xe_k, ref, rtol=1e-5, atol=1e-6))
            dx = float((xe_k - ref).abs().max())
            tag = f"{name}{' +hover_diag' if pre is not None else ''}"
            log(f"parity {tag}: steps kernel {nk} plain {np_}; max|du| {du:.3e} "
                f"(rtol {rtol}, atol {atol}); cost rel {dc:.3e}; x_evol max|dx| {dx:.3e}")
            if not (nk == np_ and ok_u and dc <= rtol and ok_x
                    and np.isfinite(st_k.yk.cpu().numpy()).all()):
                raise AssertionError(f"kernel disagrees with its plain version on {tag}")
            worst = max(worst, du)
            if timing is None:
                timing = time_fixed(AK, args, pre)
                log(f"fixed {max_iter}-iteration {tag} solve: kernel "
                    f"{timing[0]:.4f} ms (CUDA events, mean of 20), plain "
                    f"{timing[1]:.3f} ms (wall, mean of 3)")
    return worst, timing


def time_fixed(AK, args, pre, n_kernel=20, n_plain=3, **kw):
    """(kernel ms per solve, CUDA events; plain ms per solve, wall);
    ``kw`` goes to the kernel's wrapper (``cluster``); ``n_plain=0`` times
    the kernel only."""
    import torch

    for _ in range(3):
        AK.apg_solve_kernel(*args, precond=pre, **kw)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_kernel):
        AK.apg_solve_kernel(*args, precond=pre, **kw)
    e1.record()
    torch.cuda.synchronize()
    k_ms = e0.elapsed_time(e1) / n_kernel
    if not n_plain:
        return k_ms, None
    t = time.perf_counter()
    for _ in range(n_plain):
        AK.apg_solve_plain(*args, precond=pre)[0].yk.cpu()
    return k_ms, (time.perf_counter() - t) * 1e3 / n_plain


def oracles(name: str, dev):
    """(bundle, kernel oracle, plain oracle) on the parity problem."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    b = load_mpc_from_cfgfile(os.path.join(ROOT, f"configs/{name}.yaml"), device=dev)[3]
    x0, x_ref, u_prev, _ = problem(b, dev)
    args = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
            None, 1, b.apg_config.maxls)
    return b, CO.cost_oracle(*args), CO.cost_oracle_plain(*args)


def plans(K: int, seed: int, dev, n_u: int = 4):
    import numpy as np
    import torch

    u = np.random.RandomState(seed).uniform(0.3, 0.95, (K, 20, n_u)).astype(np.float32)
    return torch.from_numpy(u).to(dev)


def check_grid(b, params, dev) -> dict:
    """The rows per ``value_batch`` block the library takes at K = 1 .. 256
    against its Python mirror ``consts.value_batch_grid``; returns them."""
    import ctypes

    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts, value_batch_grid

    x0, x_ref, u_prev, _ = problem(b, dev)
    _, a = build_consts(b.model, params, b.cost_params, None, b.time_steps, x0, x_ref, u_prev)
    lib = CO.load_oracle_library()
    rows = {K: lib.value_batch_rows(ctypes.byref(a), K) for K in (1, 4, 8, 9, 17, 64, 256)}
    mirror = {K: value_batch_grid(K, a)[1] for K in rows}
    if rows != mirror or any(lib.value_batch_smem_bytes(ctypes.byref(a), K) > CO.SMEM_LIMIT
                             for K in rows):
        raise AssertionError(f"value_batch rows per block {rows}, the mirror's {mirror}")
    return rows


def phase_oracle_parity(dev) -> dict:
    """Each oracle kernel vs the plain oracle; returns max |err| per kernel.
    ``value_batch`` at K = 1 .. 256 on the register chain (8 rows a block),
    then ``value_batch`` and ``trajectory`` on the trunk padded with new
    units outside the register layout (the shared-memory step, 16 rows a
    block), one launch each."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    err = {"value_batch": 0.0, "value_and_grad": 0.0, "trajectory": 0.0}

    def batch(kern, plain, K, tag):
        U = plans(K, K, dev)
        n0 = CO.value_batch_kernel.launches
        vk = kern.value_batch(U)
        torch.cuda.synchronize()
        vp = plain.value_batch(U)
        rel = float(((vk - vp).abs() / vp.abs()).max())
        err["value_batch"] = max(err["value_batch"], float((vk - vp).abs().max()))
        log(f"oracle {tag}: value_batch K={K} max rel err {rel:.3e} (rtol 2e-5)")
        if not (rel <= 2e-5 and torch.isfinite(vk).all()
                and CO.value_batch_kernel.launches == n0 + 1):
            raise AssertionError(f"value_batch disagrees with its plain version ({tag}, K={K})")

    def traj(kern, plain, u, tag):
        n0 = CO.trajectory_kernel.launches
        x_k, x_p = kern.trajectory(u), plain.trajectory(u)
        dx = float((x_k - x_p).abs().max())
        err["trajectory"] = max(err["trajectory"], dx)
        if not (torch.allclose(x_k, x_p, rtol=1e-5, atol=1e-6)
                and CO.trajectory_kernel.launches == n0 + 1):
            raise AssertionError(f"trajectory disagrees with its plain version ({tag})")
        return dx

    for name in TOLS:
        b, kern, plain = oracles(name, dev)
        for K in (1, 4, 9, 17, 64, 256):
            batch(kern, plain, K, name)
        u = plans(1, 7, dev)[0]
        (v_k, g_k), (v_p, g_p) = kern.value_and_grad(u), plain.value_and_grad(u)
        torch.cuda.synchronize()
        ok_g = bool(torch.allclose(g_k, g_p, rtol=5e-4, atol=5e-5))
        dv = abs(float(v_k) - float(v_p)) / abs(float(v_p))
        dg = float((g_k - g_p).abs().max())
        err["value_and_grad"] = max(err["value_and_grad"], dg, abs(float(v_k - v_p)))
        dx = traj(kern, plain, u, name)
        log(f"oracle {name}: value_and_grad value rel {dv:.3e} (rtol 2e-5), grad max|d| "
            f"{dg:.3e} (rtol 5e-4, atol 5e-5); trajectory max|dx| {dx:.3e} (rtol 1e-5)")
        if not (ok_g and dv <= 2e-5):
            raise AssertionError(f"an oracle kernel disagrees with its plain version ({name})")
    log(f"value_batch rows per block by K, iris trunk: {check_grid(b, b.params, dev)}")

    params = padded_trunk(b.params, PADDED_HID, seed=0)
    x0, x_ref, u_prev, _ = problem(b, dev)
    args = (b.model, params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1, 4)
    kern, plain = CO.cost_oracle(*args), CO.cost_oracle_plain(*args)
    tag = f"iris_posctrl_mpc, its trunk padded to {PADDED_HID} units"
    for K in (1, 20, 64):
        batch(kern, plain, K, tag)
    dx = traj(kern, plain, plans(1, 7, dev)[0], tag)
    log(f"oracle {tag}: trajectory max|dx| {dx:.3e} (rtol 1e-5); value_batch rows per block "
        f"by K {check_grid(b, params, dev)}")
    return err


def phase_fixed_step_parity(dev) -> float:
    """Fixed-step APG over the kernel oracle vs the plain oracle, fixed
    budget of 30 iterations; returns max |du|."""
    import torch

    from sde4mbrl_px4_tpu_torch.solver.apg import apg_solve

    worst = 0.0
    for name, step in FIXED_STEP.items():
        b, kern, plain = oracles(name, dev)
        apg = b.apg_config._replace(use_linesearch=False, stepsize=step, max_iter=30,
                                    max_no_improvement_iter=30)
        u_init = problem(b, dev)[3]
        with torch.no_grad():
            st_k, st_p = (apg_solve(o, u_init, b.lb, b.ub, apg, precond=b.precond)
                          for o in (kern, plain))
        nk, np_ = int(st_k.num_steps), int(st_p.num_steps)
        du = float((st_k.yk - st_p.yk).abs().max())
        dc = abs(float(st_k.opt_cost) - float(st_p.opt_cost)) / abs(float(st_p.opt_cost))
        log(f"fixed-step {name}{' +hover_diag' if b.precond is not None else ''} "
            f"(stepsize {step}): steps kernel {nk} plain {np_}; max|du| {du:.3e} "
            f"(rtol 2e-4, atol 2e-5); cost {float(st_p.init_cost):.3f} -> "
            f"{float(st_k.opt_cost):.3f}, rel {dc:.3e}")
        if not (nk == np_ and torch.allclose(st_k.yk, st_p.yk, rtol=2e-4, atol=2e-5)
                and dc <= 2e-4 and float(st_k.opt_cost) < float(st_k.init_cost)):
            raise AssertionError(f"fixed-step APG disagrees on the kernels ({name})")
        worst = max(worst, du)
    return worst


def controller(dev, vehicle: str = "iris"):
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController

    return RecedingHorizonController(
        os.path.join(ROOT, f"configs/{vehicle}_traj_mpc.yaml"),
        os.path.join(ROOT, f"configs/{vehicle}_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0, device=dev)


def recording(c) -> list:
    """Collect every OptMPCStateRecord the controller publishes."""
    records = []
    solve_once = c.solve_once

    def wrapped(*a):
        rec = solve_once(*a)
        records.append(rec)
        return rec

    c.solve_once = wrapped
    return records


def phase_slice(dev, vehicle: str = "iris") -> int:
    """The whole-solve route of one airframe: its three golden replays on
    the card, each on a controller of its own; returns the launches."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G

    ctrls = [controller(dev, vehicle) for _ in range(3)]   # one per replay
    solves0 = sum(c.traj.solves + c.pos.solves for c in ctrls)
    zero_counts()
    modes, *engagement = G.replay_engagement(ctrls[2])
    results = {"pos_flagship": G.replay_pos(ctrls[0]),
               "traj_flagship": G.replay_traj(ctrls[1]),
               "engagement": engagement}
    torch.cuda.synchronize()
    solves = sum(c.traj.solves + c.pos.solves for c in ctrls) - solves0
    got = check_route(f"{vehicle} whole-solve", {"apg_solve": solves, "value_batch": 0,
                                                 "value_and_grad": 0, "trajectory": 0})
    for name, (tr, costs) in results.items():
        path = os.path.join(G.golden_dir(ROOT), f"{vehicle}_{name}_trace.npz")
        # the engagement's commands are gated from its settled window on
        # (goldens.ENGAGEMENT_GATED_FROM), its modes and indices on every tick
        first = G.ENGAGEMENT_GATED_FROM[vehicle] if name == "engagement" else 0
        res = G.compare_to_golden(tr, costs, path, first=first)
        if name == "engagement":
            # The reference gates only the flagship replays on a device
            # (bench.py:231-282). Most engagement ticks stop at max_iter
            # before converging, so their cost follows the fp rounding of
            # the chained warm starts: on an H100 the plain version and the
            # kernel both drift ~2e-3 from the CPU golden on the first
            # hold ticks, and the kernel reached 2.2e-2 on one (PERF.md).
            # Commands, modes and pickup indices are gated; the cost is
            # printed.
            res["ok"] = (res["du"] <= G.GATES["u"] and res["dw"] <= G.GATES["w"]
                         and res["idx_exact"] and bool(np.array_equal(
                             modes.astype(np.float32), np.load(path)["modes"])))
        full = G.compare_to_golden(tr, costs, path) if first else res
        if first:
            log(f"golden {vehicle}_{name} over all {len(tr)} ticks (printed): max|du| "
                f"{full['du']:.3e} max|dw| {full['dw']:.3e} cost_rel {full['cost_rel']:.3e}")
        log(f"golden {vehicle}_{name} ({len(tr) - first} ticks from tick {first}): max|du| "
            f"{res['du']:.3e} "
            f"max|dw| {res['dw']:.3e} cost_rel {res['cost_rel']:.3e} idx "
            f"{'exact' if res['idx_exact'] else 'MISMATCH'} -> {'PASS' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            raise AssertionError(f"golden gate failed for {vehicle}_{name}: {res}")
    return got["apg_solve"]


@contextlib.contextmanager
def routed(name: str, fn):
    """Route the loader's ``name`` (``apg_solve_kernel`` or ``cost_oracle``)
    through ``fn`` (measurement and parity only)."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader

    orig = getattr(mpc_loader, name)
    setattr(mpc_loader, name, fn)
    try:
        yield
    finally:
        setattr(mpc_loader, name, orig)


def phase_mppi(dev) -> dict:
    """The MPPI route: the family replay through the kernels (counted) and
    through the plain oracle, then the K=256 closed loop."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    n, iters = 4, 8
    zero_counts()
    tr_k = G.replay_solver_family(ROOT, "mppi", n=n, device=dev)
    torch.cuda.synchronize()
    got = check_route("MPPI", {"apg_solve": 0, "value_batch": n * (iters + 2),
                               "value_and_grad": 0, "trajectory": n})
    with routed("cost_oracle", CO.cost_oracle_plain):
        tr_p = G.replay_solver_family(ROOT, "mppi", n=n, device=dev)
    du = np.abs(tr_k[:, :-1] - tr_p[:, :-1]).max(axis=1)
    log(f"MPPI family replay ({n} solves, K=64, {iters} rounds), kernels vs plain, same "
        f"draws: max|du| per row {np.array2string(du, precision=3)} (gate 1e-4); steps "
        f"{tr_k[:, -1].tolist()} vs {tr_p[:, -1].tolist()}")
    if not ((du <= 1e-4).all() and np.array_equal(tr_k[:, -1], tr_p[:, -1])
            and np.isfinite(tr_k).all()):
        raise AssertionError("MPPI through the kernels disagrees with the plain oracle")

    cfg = config("iris_posctrl_mpc", solver="mppi",
                 mppi={"samples": 256, "sigma": 0.02, "temperature": 0.1,
                       "iters": 8, "noise_beta": 0.7})
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device=dev)
    x = hover_state(dev)
    x[0] = 1.0
    tgt = hover_state(dev)
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    e0 = float(torch.linalg.norm(x[:3]))
    for _ in range(30):
        u, st, gen, x_evol = mpc_fn(x, gen, st, 0.0, tgt)
        x = x_evol[1]
    e1 = float(torch.linalg.norm(x[:3]))
    log(f"MPPI closed loop (K=256, 30 ticks) through the kernels: position error "
        f"{e0:.3f} -> {e1:.4f} m (gate < {0.35 * e0:.3f})")
    if not (e1 < 0.35 * e0 and bool(torch.isfinite(u).all())):
        raise AssertionError("the MPPI closed loop did not close the position step")
    return got


def chain(cfg: dict, dev, n: int, make=None):
    """``n`` chained solves of one config's ``mpc_fn`` from the pinned
    offset state of the family replays: (rows [u0, num_steps], wall ms
    per solve from dispatch to the plan on the host). ``make(cfg, dev)``
    loads the config (default ``make_mpc_from_config``)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    if make is None:
        cfg, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    else:
        cfg, (reset_fn, mpc_fn), _, _ = make(cfg, dev)
    dt = float(cfg["_time_steps"][0])
    x = hover_state(dev)
    x[0], x[2] = 0.5, -0.3
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    rows, ms = [], []
    for k in range(n):
        t = time.perf_counter()
        u, st, gen, x_evol = mpc_fn(x, gen, st, k * dt, x)
        u0 = u[0].cpu().numpy()
        ms.append((time.perf_counter() - t) * 1e3)
        x = x_evol[1]
        rows.append(np.concatenate([u0, [float(st.num_steps)]]))
    return np.stack(rows), ms


def phase_fixed_step(dev) -> dict:
    """The fixed-step route: chained solves of the posctrl config without its
    linesearch block, through the kernels."""
    import numpy as np
    import torch

    n = 3
    cfg = config("iris_posctrl_mpc", linesearch=None,
                 stepsize=FIXED_STEP["iris_posctrl_mpc"])
    zero_counts()
    rows, _ = chain(cfg, dev, n)
    torch.cuda.synchronize()
    steps = int(rows[:, -1].sum())
    got = check_route("fixed-step", {"apg_solve": 0, "value_batch": steps,
                                     "value_and_grad": steps + 2 * n, "trajectory": n})
    log(f"fixed-step route: {n} chained solves at {rows[:, -1].tolist()} iterations, "
        f"u0 {np.array2string(rows[-1, :-1], precision=4)}")
    if not (np.isfinite(rows).all() and (rows[:, :-1] >= 1e-4 - 1e-7).all()):
        raise AssertionError("the fixed-step route returned an invalid plan")
    return got


def chained(dev, mode: str, n: int, warm: int, vehicle: str = "iris"):
    """(p50 wall ms, mean iterations, iterations per tick) per solve over
    ticks ``warm+1..n``."""
    from sde4mbrl_px4_tpu_torch.engine import goldens as G

    c = controller(dev, vehicle)
    records = recording(c)
    (G.replay_pos if mode == "pos" else G.replay_traj)(c, n=n)
    tail = records[warm:]
    return (statistics.median(r.solve_time for r in tail) * 1e3,
            statistics.mean(r.num_steps for r in tail), [r.num_steps for r in tail])


def event_timed(events: list):
    """The whole-solve kernel's wrapper with CUDA events recorded around each
    call: the device span of one solve (consts packing plus the kernel)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    def solve(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = AK.apg_solve_kernel(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    return solve


def phase_split(dev, card: str, n: int = 3) -> dict:
    """The whole-solve kernel's phase split: the chained flagship traj
    replay (a controller, ``n`` ticks) through the kernel's clock-stamped
    instantiation (``apg_phase_split``); the split of the last solve: each
    phase's share of the solve's SM cycles (thread 0's stamps), and that
    share of the solve's device span (CUDA events) per APG iteration."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    events, cycles = [], []

    def solve(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = AK.apg_phase_split(*args, **kw)
        e1.record()
        events.append((e0, e1))
        cycles.append(AK.apg_phase_split.cycles)
        return out

    c = controller(dev)
    records = recording(c)
    with routed("apg_solve_kernel", solve):
        G.replay_traj(c, n=n)
    torch.cuda.synchronize()
    cyc = cycles[-1].cpu().tolist()
    span, steps = events[-1][0].elapsed_time(events[-1][1]), float(records[-1].num_steps)
    share = {name: cyc[i] / cyc[len(AK.PHASES)] for i, name in enumerate(AK.PHASES)}
    out = {"iterations": steps, "device_ms": span, "cycles": cyc[len(AK.PHASES)],
           "iteration_ms": {k: v * span / steps for k, v in share.items()}, "share": share}
    log(f"phase split of traj replay tick {n} ({card}; clock-stamped instantiation, thread "
        f"0): {steps:.0f} iterations, {span:.3f} ms device span, {out['cycles']} cycles; "
        + "; ".join(f"{k} {100 * v:.1f} % ({out['iteration_ms'][k]:.4f} ms/iteration)"
                    for k, v in share.items()))
    if abs(sum(share.values()) - 1.0) > 0.01 or steps < 1:
        raise AssertionError(f"the phase split does not cover the solve: {share}")
    return out


def per_launch_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls (CUDA events, warm)."""
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


def phase_timing(dev, card: str) -> dict:
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    out = {}
    # the plain version has nothing to compile or warm: its replays time
    # their first tick only (its iteration count is printed beside it)
    n_kernel, warm, n_plain = 6, 1, 1
    for mode in ("pos", "traj"):
        events = []
        with routed("apg_solve_kernel", event_timed(events)):
            k_ms, k_steps, ticks = chained(dev, mode, n_kernel, warm)
        torch.cuda.synchronize()
        spans = [a.elapsed_time(b) for a, b in events[-(n_kernel - warm):]]
        dev_ms = statistics.median(spans)
        it_ms = statistics.median(d / n for d, n in zip(spans, ticks))
        with routed("apg_solve_kernel", AK.apg_solve_plain):
            p_ms, p_steps, _ = chained(dev, mode, n_plain, 0)
        out[mode] = (k_ms, p_ms, dev_ms, k_steps, it_ms)
        log(f"chained iris/{mode} replay, per solve p50 ({card}): kernel {k_ms:.3f} ms "
            f"wall ({dev_ms:.3f} ms device span) at {k_steps:.1f} iterations over ticks "
            f"{warm + 1}-{n_kernel} ({it_ms:.4f} ms device span per iteration, p50), plain "
            f"{p_ms:.3f} ms wall at {p_steps:.1f} iterations on tick 1")
    out["split"] = phase_split(dev, card)

    routes = {"mppi": (config("iris_posctrl_mpc", solver="mppi"), 8, 8, warm),
              "fixed_step": (config("iris_posctrl_mpc", linesearch=None,
                                    stepsize=FIXED_STEP["iris_posctrl_mpc"]), 6, 1, 0)}
    for route, (cfg, n_k, n_p, w_p) in routes.items():
        rows_k, ms_k = chain(cfg, dev, n_k)
        with routed("cost_oracle", CO.cost_oracle_plain):
            rows_p, ms_p = chain(cfg, dev, n_p)
        out[route] = (statistics.median(ms_k[warm:]), statistics.median(ms_p[w_p:]))
        log(f"chained {route} solves, per solve p50 ({card}): kernels "
            f"{out[route][0]:.3f} ms wall over ticks {warm + 1}-{n_k} at "
            f"{rows_k[warm:, -1].mean():.1f} iterations, plain {out[route][1]:.3f} ms "
            f"wall over ticks {w_p + 1}-{n_p} at {rows_p[w_p:, -1].mean():.1f}")

    _, kern, plain = oracles("iris_posctrl_mpc", dev)
    U, U256, u = plans(64, 1, dev), plans(256, 1, dev), plans(1, 2, dev)[0]
    calls = {"value_batch": lambda o: o.value_batch(U),
             "value_batch_K256": lambda o: o.value_batch(U256),
             "value_and_grad": lambda o: o.value_and_grad(u),
             "trajectory": lambda o: o.trajectory(u)}
    for name, call in calls.items():
        out[name] = (per_launch_ms(lambda: call(kern), 50),
                     per_launch_ms(lambda: call(plain), 5))
        log(f"{name.replace('_K256', ' K=256')}{' K=64' if name == 'value_batch' else ''} per "
            f"launch ({card}): kernel {out[name][0]:.4f} ms, plain {out[name][1]:.3f} ms "
            f"(CUDA events)")
    return out


def brownian(P: int, dev, antithetic: bool = False, seed: int = None):
    """A (P, H, 13) Brownian block from a seeded CPU generator."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian

    gen = torch.Generator().manual_seed(P if seed is None else seed)
    return draw_brownian(gen, 20, P, antithetic, dev).transpose(0, 1)


def rollout_spread(b, x0, u) -> tuple:
    """(x64, spread): the mean rollout of ``u`` in float64 on the CPU, and
    per element the largest distance from it of four float32 rollouts of
    the same function: on the card and on the CPU, each with the motors in
    their order and reversed (a reversal permutes the mixing columns, the
    first layer's control rows and the plan's columns together, so only the
    summation order moves)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    def cast(t, **kw):
        return {k: cast(v, **kw) for k, v in t.items()} if isinstance(t, dict) else t.to(**kw)

    def rollout(perm, **kw):
        net = dict(b.params["net"])
        net["w0"] = torch.cat([net["w0"][:9], net["w0"][9:][perm]])
        params = cast({**b.params, "net": net}, **kw)
        model = b.model._replace(mixing=b.model.mixing[:, perm].to(**kw),
                                 inertia=b.model.inertia.to(**kw))
        return rollout_mean(model, params, x0.to(**kw), u[:, perm].to(**kw),
                            b.time_steps.to(**kw)).to(device="cpu", dtype=torch.float64)

    n_u = u.shape[1]
    orders = (list(range(n_u)), list(range(n_u))[::-1])
    x64 = rollout(orders[0], device="cpu", dtype=torch.float64)
    spread = torch.zeros_like(x64)
    for dev in (b.device, torch.device("cpu")):
        for perm in orders:
            x32 = rollout(perm, device=dev, dtype=torch.float32)
            spread = torch.maximum(spread, (x32 - x64).abs())
    return x64, spread


def particle_solve_parity(AK, b, args, chunk: int, tag: str,
                          what: str = "particle solve", fp32_spread: bool = False) -> tuple:
    """A particle (or state-constrained) solve through the kernel and the
    plain version: equal steps, ``yk`` and ``opt_cost`` at the particle
    tolerances, ``x_evol`` (the ``trajectory`` launch, or the P=1 exit
    sweep's) the mean rollout of the control columns of the kernel's plan
    at rtol 1e-5 / atol 1e-6. With ``fp32_spread`` ``x_evol`` is held to
    the float64 rollout instead, each element within rtol 1e-5 / atol 1e-6
    plus twice the float32 spread of the plain rollout there
    (``rollout_spread``: a plan whose float32 rollout moves past 1e-5 with
    the summation order). Returns (max |du|, max |dx| of ``x_evol``,
    steps)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    st_k, xe_k = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk)
    torch.cuda.synchronize()
    st_p, _ = AK.apg_solve_plain(*args, precond=b.precond, chunk=chunk)
    nk, np_ = int(st_k.num_steps), int(st_p.num_steps)
    du = float((st_k.yk - st_p.yk).abs().max())
    dc = abs(float(st_k.opt_cost) - float(st_p.opt_cost)) / abs(float(st_p.opt_cost))
    u = st_k.yk[:, :b.model.n_u]
    ref = rollout_mean(b.model, b.params, args[5], u, b.time_steps)
    dx = float((xe_k - ref).abs().max())
    ok_x = bool(torch.allclose(xe_k, ref, rtol=1e-5, atol=1e-6))
    spread = ""
    if fp32_spread:
        x64, f32 = rollout_spread(b, args[5], u)
        gap = (xe_k.cpu().double() - x64).abs()
        ok_x = bool((gap <= 1e-5 * x64.abs() + 1e-6 + 2 * f32).all())
        spread = (f"; against float64: the kernel max {float(gap.max()):.3e}, the float32 "
                  f"spread of the plain rollout max {float(f32.max()):.3e}")
    log(f"{what} {tag}: steps kernel {nk} plain {np_}; max|du| {du:.3e} "
        f"(rtol {PART_RTOL}, atol {PART_ATOL}); cost rel {dc:.3e} (5e-4); x_evol "
        f"max|dx| {dx:.3e} (rtol 1e-5{'; held to float64 + twice the spread' if fp32_spread else ''})"
        f"{spread}")
    if not (nk == np_ and torch.allclose(st_k.yk, st_p.yk, rtol=PART_RTOL, atol=PART_ATOL)
            and dc <= PART_RTOL and ok_x and bool(torch.isfinite(st_k.yk).all())):
        raise AssertionError(f"the {what} disagrees with its plain version ({tag})")
    return du, dx, nk


def phase_particle_parity(dev) -> dict:
    """The noise and chunk branches of every kernel against the plain
    versions on the same draws; returns max |err| per kernel."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    err = {"apg_solve": 0.0, "value_batch": 0.0, "value_and_grad": 0.0}
    for name in TOLS:
        b = load_mpc_from_cfgfile(os.path.join(ROOT, f"configs/{name}.yaml"), device=dev)[3]
        x0, x_ref, u_prev, u_init = problem(b, dev)
        apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
        # one chunk; 4 chunks; 3 chunks (a cluster of 3); 32 antithetic
        # chunks (more chunks than blocks)
        for P, chunk, anti in ((8, 0, False), (64, 16, False), (96, 32, False),
                               (1024, 0, True)):
            z = brownian(P, dev, antithetic=anti)
            tag = f"{name} P={P}{' antithetic' if anti else ''} chunk={chunk or 'auto'}"
            oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
                     z, P, b.apg_config.maxls)
            kern = CO.cost_oracle(*oargs, chunk=chunk)
            plain = CO.cost_oracle_plain(*oargs, chunk=chunk)
            U = plans(4, P, dev)
            for kernel, e in particle_oracle_parity(kern, plain, U, tag).items():
                err[kernel] = max(err[kernel], e)
            one = CO.cost_oracle(*oargs, chunk=chunk, cluster=1)
            for Ub in (U, plans(9, P + 9, dev)):
                batch_cluster_vs_one(kern, one, Ub, tag)
            (v_c, g_c), (v_1, g_1) = kern.value_and_grad(U[1]), one.value_and_grad(U[1])
            dg = float((g_c - g_1).abs().max())
            log(f"value_and_grad {tag}, its cluster against C = 1: |dv| "
                f"{abs(float(v_c - v_1)):.3e}, max|dg| {dg:.3e} (1e-6; equal bits expected)")
            if not (abs(float(v_c - v_1)) <= 1e-6 * abs(float(v_1))
                    and bool(torch.allclose(g_c, g_1, rtol=1e-6, atol=0))):
                raise AssertionError(f"value_and_grad moves with its cluster size ({tag})")
            args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev,
                    z, P, b.lb, b.ub, u_init)
            err["apg_solve"] = max(err["apg_solve"],
                                   particle_solve_parity(AK, b, args, chunk, tag)[0])
            cluster_vs_one(AK, args, chunk, b.precond, tag)
    return err


def batch_cluster_vs_one(kern, one, U, tag: str) -> None:
    """``value_batch`` on its grid of K clusters against ``cluster=1`` (one
    block per candidate sweeping every chunk): equal
    bits, since every block sums the chunks' partials in chunk order."""
    import torch

    vk, v1 = kern.value_batch(U), one.value_batch(U)
    torch.cuda.synchronize()
    log(f"value_batch {tag}, K={len(U)} on its clusters against C = 1: max|d| "
        f"{float((vk - v1).abs().max()):.3e} (equal bits)")
    if not torch.equal(vk, v1):
        raise AssertionError(f"value_batch moves with its cluster size ({tag}, K={len(U)})")


def cluster_vs_one(AK, args, chunk: int, pre, tag: str) -> dict:
    """A particle solve at its chosen cluster and at C = 1 (one block
    sweeping every chunk): equal steps, max|du| and the relative
    ``opt_cost`` gap within 1e-6 (equal bits expected: the blocks sum the
    chunks' partials in chunk order). Returns the plan of the chosen
    cluster and both results."""
    import ctypes

    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    st_c, _ = AK.apg_solve_kernel(*args, precond=pre, chunk=chunk)
    st_1, _ = AK.apg_solve_kernel(*args, precond=pre, chunk=chunk, cluster=1)
    torch.cuda.synchronize()
    model, params, cp, apg, ts, x0, x_ref, u_prev, _, P, lb, ub, _ = args
    _, a = build_consts(model, params, cp, apg, ts, x0, x_ref, u_prev, lb, ub,
                        has_pre=pre is not None)
    AK.plan_solve_particles(a, P, chunk)
    lib = AK.load_apg_library()
    n = ctypes.c_int(0)
    rc = lib.apg_max_active_clusters(ctypes.byref(a), ctypes.byref(n))
    out = {"cluster": a.cluster, "chunks_per_block": a.chunks_per_block, "Pc": a.Pc,
           "n_chunks": a.n_chunks, "c_max": lib.apg_cluster_max(a.sc_kind, 0),
           "max_active_clusters": n.value if rc == 0 else f"error {rc}",
           "steps": (int(st_c.num_steps), int(st_1.num_steps)),
           "du": float((st_c.yk - st_1.yk).abs().max()),
           "dc": abs(float(st_c.opt_cost) - float(st_1.opt_cost)) / abs(float(st_1.opt_cost))}
    log(f"particle solve {tag}, cluster C={a.cluster} (C_max {out['c_max']}, "
        f"{a.chunks_per_block} chunk(s) per block of {a.n_chunks} of Pc={a.Pc}; "
        f"cudaOccupancyMaxActiveClusters {out['max_active_clusters']}) against C = 1: steps "
        f"{out['steps'][0]} / {out['steps'][1]}; max|du| {out['du']:.3e}, opt_cost rel "
        f"{out['dc']:.3e} (1e-6; equal bits expected)")
    if not (out["steps"][0] == out["steps"][1] and out["du"] <= 1e-6 and out["dc"] <= 1e-6):
        raise AssertionError(f"the particle solve moves with its cluster size ({tag})")
    return out


def particle_oracle_parity(kern, plain, U, tag: str, what: str = "particle oracle") -> dict:
    """The particle (or state-constrained) oracle kernels against the plain
    oracle on the same draws: ``value`` (``value_batch`` at K=1) and
    ``value_batch`` at K=len(U) at rtol 2e-5, ``value_and_grad`` (value
    rtol 2e-5, gradient rtol 5e-4 / atol 5e-5). Returns max |err| per
    kernel."""
    import torch

    vk, vp = kern.value_batch(U), plain.value_batch(U)
    v1k, v1p = kern.value(U[0]), plain.value(U[0])
    (a_k, g_k), (a_p, g_p) = kern.value_and_grad(U[1]), plain.value_and_grad(U[1])
    torch.cuda.synchronize()
    rel = max(float(((vk - vp).abs() / vp.abs()).max()),
              abs(float(v1k) - float(v1p)) / abs(float(v1p)))
    dv = abs(float(a_k) - float(a_p)) / abs(float(a_p))
    dg = float((g_k - g_p).abs().max())
    log(f"{what} {tag}: value (K=1) / value_batch K={len(U)} max rel err "
        f"{rel:.3e} (rtol 2e-5); value_and_grad value rel {dv:.3e}, grad max|d| {dg:.3e} "
        f"(rtol 5e-4, atol 5e-5)")
    if not (rel <= 2e-5 and dv <= 2e-5 and bool(torch.isfinite(vk).all())
            and bool(torch.isfinite(g_k).all())
            and torch.allclose(g_k, g_p, rtol=5e-4, atol=5e-5)):
        raise AssertionError(f"a {what} kernel disagrees with its plain version ({tag})")
    return {"value_batch": max(float((vk - vp).abs().max()), abs(float(v1k - v1p))),
            "value_and_grad": max(dg, abs(float(a_k - a_p)))}


def phase_particle_family(dev) -> tuple:
    """``replay_solver_family("p512anti")`` through the kernels (counted)
    and through the plain version; returns (launches, max |du|)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    n = 4
    zero_counts()
    tr_k = G.replay_solver_family(ROOT, "p512anti", n=n, device=dev)
    torch.cuda.synchronize()
    got = check_route("p512anti family", {"apg_solve": n, "value_batch": 0,
                                          "value_and_grad": 0, "trajectory": n})
    with routed("apg_solve_kernel", AK.apg_solve_plain):
        tr_p = G.replay_solver_family(ROOT, "p512anti", n=n, device=dev)
    du = np.abs(tr_k[:, :-1] - tr_p[:, :-1]).max(axis=1)
    log(f"p512anti family replay ({n} solves, max_iter 6), kernels vs plain, same draws: "
        f"max|du| per row {np.array2string(du, precision=3)} (gate 5e-4); steps "
        f"{tr_k[:, -1].tolist()} vs {tr_p[:, -1].tolist()}")
    if not ((du <= 5e-4).all() and np.array_equal(tr_k[:, -1], tr_p[:, -1])
            and np.isfinite(tr_k).all()):
        raise AssertionError("the p512anti family through the kernels disagrees with plain")
    return got, float(du.max())


def phase_particle_flight(dev, card: str) -> dict:
    """The full-width route: iris_traj_mpc at P=512 antithetic, chained
    through ``mpc_fn`` along the lemniscate, then flown by a controller;
    a fixed 5-iteration solve kernel vs plain; the chosen chunk."""
    import ctypes

    import numpy as np
    import torch
    import yaml

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    cfg0 = config("iris_traj_mpc", particles=P_FULL)
    cfg, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(cfg0), device=dev)
    dt, t0, n, warm = float(cfg["_time_steps"][0]), 3.0, 7, 1
    x = enu2ned(sft(np.float32(t0)))
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    events, wall, steps, track = [], [], [], []
    zero_counts()
    with routed("apg_solve_kernel", event_timed(events)):
        for k in range(n):
            w0 = time.perf_counter()
            u, st, gen, x_evol = mpc_fn(x, gen, st, np.float32(t0 + k * dt), x)
            u0 = u[0].cpu()
            wall.append((time.perf_counter() - w0) * 1e3)
            steps.append(int(st.num_steps))
            x = x_evol[1]
            ref = enu2ned(sft(np.float32(t0 + (k + 1) * dt)))
            track.append(float(torch.linalg.norm(x[:3] - ref[:3])))
            if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(x_evol).all())
                    and bool(torch.isfinite(u0).all())):
                raise AssertionError(f"P={P_FULL} solve {k} returned non-finite values")
    torch.cuda.synchronize()
    got = check_route(f"P={P_FULL} flight", {"apg_solve": n, "value_batch": 0,
                                             "value_and_grad": 0, "trajectory": n})
    dev_ms = [a.elapsed_time(e) for a, e in events]
    tail = slice(warm, n)
    out = {"launches": got,
           "wall_ms": statistics.median(wall[tail]),
           "device_ms": statistics.median(dev_ms[tail]),
           "steps": statistics.mean(steps[tail]),
           "iter_ms": statistics.median(d / s for d, s in zip(dev_ms[tail], steps[tail])),
           "track_m": max(track)}
    log(f"P={P_FULL} antithetic traj route through mpc_fn, {n} chained ticks along the "
        f"lemniscate ({card}): per solve p50 {out['wall_ms']:.3f} ms wall, "
        f"{out['device_ms']:.3f} ms device span (solve + trajectory) over ticks "
        f"{warm + 1}-{n}; iterations {steps}; per iteration p50 {out['iter_ms']:.4f} ms; "
        f"|x_evol[1] - ref| per tick {np.array2string(np.array(track), precision=4)} m "
        f"(gate 0.5 m)")
    if max(track) > 0.5 or min(steps) < 1:
        raise AssertionError(f"the P={P_FULL} route did not track the lemniscate")

    # the same config flown by the controller
    path = os.path.join(ROOT, "build", "chip_smoke", f"iris_traj_p{P_FULL}anti.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg0.items() if not k.startswith("_")}, f)
    c = RecedingHorizonController(path, os.path.join(ROOT, "configs/iris_posctrl_mpc.yaml"),
                                  seed=0, now_fn=lambda: 0.0, device=dev)
    traj0, pos0 = c.traj.solves, c.pos.solves
    zero_counts()
    cmds, _ = G.replay_traj(c, n=3)
    torch.cuda.synchronize()
    n_traj, n_pos = c.traj.solves - traj0, c.pos.solves - pos0
    check_route(f"P={P_FULL} controller", {"apg_solve": n_traj + n_pos, "value_batch": 0,
                                           "value_and_grad": 0, "trajectory": n_traj})
    log(f"RecedingHorizonController flying P={P_FULL}: {n_traj} traj solves, commands "
        f"u0 {np.array2string(cmds[-1, :4], precision=4)}, pickup idx {cmds[:, 10].tolist()}")
    if not (n_traj == 3 and np.isfinite(cmds).all()):
        raise AssertionError(f"the controller did not fly the P={P_FULL} config")

    # a fixed 5-iteration solve at P=512: parity and kernel vs plain time
    x0, x_ref, u_prev, u_init = problem(b, dev)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    z = brownian(P_FULL, dev, antithetic=True, seed=0)
    args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, z,
            P_FULL, b.lb, b.ub, u_init)
    out["max_du"], out["max_dx"], out["fixed_steps"] = particle_solve_parity(
        AK, b, args, 0, f"iris_traj_mpc P={P_FULL} antithetic")
    out["fixed_ms"], out["fixed_plain_ms"] = time_fixed(AK, args, b.precond, n_kernel=5,
                                                        n_plain=2)
    out["fixed_ms_c1"] = time_fixed(AK, args, b.precond, n_kernel=3, n_plain=0, cluster=1)[0]
    log(f"fixed 5-iteration P={P_FULL} traj solve ({card}): kernel {out['fixed_ms']:.3f} ms "
        f"(CUDA events, mean of 5, solve + trajectory; {out['fixed_ms_c1']:.3f} ms at C = 1, "
        f"mean of 3), plain {out['fixed_plain_ms']:.3f} ms (wall, mean of 2)")
    out["cluster"] = cluster_vs_one(AK, args, 0, b.precond,
                                    f"iris_traj_mpc P={P_FULL} antithetic, 5 iterations")
    out["split"] = particle_phase_split(AK, args, b.precond, card,
                                        f"the fixed 5-iteration P={P_FULL} traj solve")

    _, a = build_consts(b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref,
                        u_prev, b.lb, b.ub, has_pre=b.precond is not None)
    AK.plan_solve_particles(a, P_FULL, 0)
    out["Pc"], out["smem"] = a.Pc, AK.load_apg_library().apg_smem_bytes(ctypes.byref(a))
    lib = CO.load_oracle_library()
    _, o = build_consts(b.model, b.params, b.cost_params, None, b.time_steps, x0, x_ref, u_prev)
    CO.plan_oracle_particles(lib, o, P_FULL, 0)
    out["oracle_Pc"] = o.Pc
    out["oracle_smem"] = (lib.value_batch_smem_bytes(ctypes.byref(o), 4),
                          lib.value_and_grad_smem_bytes(ctypes.byref(o)))
    log(f"chunks at P={P_FULL}: whole solve Pc={a.Pc} ({a.n_chunks} chunks), apg_smem_bytes "
        f"{out['smem']} (budget {AK.SMEM_LIMIT_PARTICLES}); oracle Pc={o.Pc}, "
        f"value_batch {out['oracle_smem'][0]} B, value_and_grad {out['oracle_smem'][1]} B")
    return out


def particle_phase_split(AK, args, pre, card: str, what: str) -> dict:
    """The phase split of one particle solve without state constraints
    through the kernel's clock-stamped instantiation (``apg_phase_split``):
    each phase's share of the solve's SM cycles (thread 0's stamps) on
    cluster rank 0 and on the last rank, and rank 0's shares of the
    solve's device span (CUDA events around the solve and its
    ``trajectory`` launch) per APG iteration."""
    import torch

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    st, _ = AK.apg_phase_split(*args, precond=pre)
    e1.record()
    torch.cuda.synchronize()
    rows = AK.apg_phase_split.cycles.view(-1, 8).cpu().tolist()
    span, steps = e0.elapsed_time(e1), float(st.num_steps)
    names = AK.PART_PHASES
    out = {"iterations": steps, "device_ms": span, "ranks": {}}
    for row in rows:
        share = {k: row[i] / row[6] for i, k in enumerate(names)}
        out["ranks"][int(row[7])] = {"cycles": row[6], "share": share}
        log(f"phase split of {what} ({card}; clock-stamped instantiation, thread 0 of rank "
            f"{int(row[7])}): {steps:.0f} iterations, {span:.3f} ms device span, {row[6]} "
            "cycles; " + "; ".join(f"{k} {100 * v:.1f} % ({v * span / steps:.4f} "
                                    f"ms/iteration)" for k, v in share.items()))
        if abs(sum(share.values()) - 1.0) > 0.01 or steps < 1:
            raise AssertionError(f"the particle phase split does not cover the solve: {share}")
    out["iteration_ms"] = {k: v * span / steps
                           for k, v in out["ranks"][int(rows[0][7])]["share"].items()}
    return out


def phase_particle_oracle(dev, card: str) -> dict:
    """The fixed-step route at P=512 antithetic on the oracle kernels'
    particle branches (counted; its iterations and wall time per
    iteration), then those kernels
    against plain and their per-launch times: ``value_batch`` at K=1 (what
    the route launches) and K=4, each also at C = 1 (equal bits)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    n = 2
    cfg = config("iris_posctrl_mpc", linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"],
                 particles=P_FULL)
    zero_counts()
    rows, ms = chain(cfg, dev, n)
    torch.cuda.synchronize()
    steps = int(rows[:, -1].sum())
    got = check_route(f"fixed-step P={P_FULL}", {"apg_solve": 0, "value_batch": steps,
                                                 "value_and_grad": steps + 2 * n,
                                                 "trajectory": n})
    iteration_ms = [m / max(k, 1) for m, k in zip(ms, rows[:, -1])]
    log(f"fixed-step route at P={P_FULL} antithetic ({card}): {n} chained solves at "
        f"{rows[:, -1].tolist()} iterations, {np.array2string(np.array(ms), precision=1)} ms "
        f"wall, {np.array2string(np.array(iteration_ms), precision=3)} ms per iteration, u0 "
        f"{np.array2string(rows[-1, :-1], precision=4)}")
    if not (np.isfinite(rows).all() and (rows[:, :-1] >= 1e-4 - 1e-7).all()):
        raise AssertionError(f"the fixed-step route at P={P_FULL} returned an invalid plan")

    b = load_mpc_from_cfgfile(os.path.join(ROOT, "configs/iris_posctrl_mpc.yaml"),
                              device=dev)[3]
    x0, x_ref, u_prev, _ = problem(b, dev)
    oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
             brownian(P_FULL, dev, antithetic=True, seed=0), P_FULL, b.apg_config.maxls)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    one = CO.cost_oracle(*oargs, cluster=1)
    U, u = plans(4, 3, dev), plans(1, 4, dev)[0]
    tag = f"iris_posctrl_mpc P={P_FULL} antithetic, the route's chunk"
    out = {"launches": got, "err": particle_oracle_parity(kern, plain, U, tag),
           "iteration_ms": statistics.median(iteration_ms), "iterations": rows[:, -1].tolist()}
    for Ub in (U[:1], U):
        batch_cluster_vs_one(kern, one, Ub, tag)
    for name, call in (("value_batch", lambda o: o.value_batch(U[:1])),
                       ("value_batch_K4", lambda o: o.value_batch(U)),
                       ("value_and_grad", lambda o: o.value_and_grad(u))):
        out[name] = (per_launch_ms(lambda: call(kern), 20), per_launch_ms(lambda: call(plain), 3),
                     per_launch_ms(lambda: call(one), 5))
        log(f"{name.replace('_K4', ' K=4')}{' K=1' if name == 'value_batch' else ''} at "
            f"P={P_FULL} per launch ({card}): kernel {out[name][0]:.4f} ms ({out[name][2]:.4f} "
            f"ms at C = 1), plain {out[name][1]:.3f} ms (CUDA events)")
    out["plan"] = oracle_plan(b, dev, P_FULL)
    log(f"the particle oracle at P={P_FULL}: clusters of {out['plan']['cluster']} blocks "
        f"({out['plan']['chunks_per_block']} chunk(s) of Pc={out['plan']['Pc']} each), "
        f"value_batch one per candidate, C_max and cudaOccupancyMaxActiveClusters "
        f"{ {k: out['plan'][k] for k in ('value_batch', 'value_and_grad')} }; the route's "
        f"wall time per iteration p50 {out['iteration_ms']:.3f} ms")
    return out


def oracle_plan(b, dev, P: int, constrained: bool = False) -> dict:
    """The chunk and cluster the oracle's particle kernels take for b at P
    particles, each kernel's largest cluster and
    ``cudaOccupancyMaxActiveClusters`` at that cluster."""
    import ctypes

    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_problem
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (ORACLE_VALUE_AND_GRAD,
                                                        ORACLE_VALUE_BATCH, build_consts)

    x0, x_ref, u_prev, _ = constrained_problem(b) if constrained else problem(b, dev)
    _, o = build_consts(b.model, b.params, b.cost_params, None, b.time_steps, x0, x_ref,
                        u_prev)
    lib = CO.load_oracle_library()
    CO.plan_oracle_particles(lib, o, P, 0)
    out = {"Pc": o.Pc, "cluster": o.cluster, "chunks_per_block": o.chunks_per_block}
    for name, kind in (("value_batch", ORACLE_VALUE_BATCH),
                       ("value_and_grad", ORACLE_VALUE_AND_GRAD)):
        n = ctypes.c_int(0)
        rc = lib.oracle_max_active_clusters(kind, ctypes.byref(o), ctypes.byref(n))
        out[name] = {"c_max": lib.oracle_cluster_max(kind, o.sc_kind),
                     "max_active_clusters": n.value if rc == 0 else f"error {rc}"}
    return out


def constrained_config(form: str, **mut) -> dict:
    """``configs/iris_constr_posctrl_mpc.yaml`` in the proximal form as
    shipped (``form="prox"``) or its penalty form, with ``mut`` as
    :func:`config` takes it."""
    cfg = config(SHIPPED, **mut)
    cfg["state_constr"]["slack_proximal"] = form == "prox"
    return cfg


def floor_config(**mut) -> dict:
    """The particle route of ``examples/noise_robustness.py``: the posctrl
    config with its altitude floor (penalty form), P=128 antithetic,
    max_iter 60; :func:`floor_mpc` loads it at the example's noise."""
    mut.setdefault("max_iter", 60)
    mut.setdefault("max_no_improvement_iter", mut["max_iter"])
    cfg = config("iris_posctrl_mpc", particles=P_FLOOR, **mut)
    cfg["state_constr"] = copy.deepcopy(FLOOR)
    return cfg


def floor_mpc(cfg: dict, dev):
    """``make_mpc_from_config`` of a :func:`floor_config`, with the model's
    diffusion at the example's noise scale, as the example sets it
    (``params["diffusion_log_scale"] = log(0.6)``)."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    made = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    made[3].params["diffusion_log_scale"].fill_(math.log(FLOOR_NOISE))
    return made


def trunk_flops(b) -> int:
    """Multiply-add FLOPs of one row's trunk, (9+n_u) -> HID -> HID -> 12:
    the work of one row of one step forward, and of its transposed products
    in a reverse step (the rigid-body arithmetic is left out, so bounds
    built on it are lower bounds)."""
    net = b.params["net"]
    F, HID, OUT = int(net["w0"].shape[0]), int(net["w1"].shape[0]), int(net["w2"].shape[1])
    return 2 * (F * HID + HID * HID + HID * OUT)


def work(b, kind: str, P: int = 1, K: int = 1, iters: int = 0) -> int:
    """FLOPs of one call, from its shapes: ``value_batch`` K x P rows
    forward over H steps; ``value_and_grad`` P rows forward and reverse
    (one trunk pass each way: that the particle forms re-run the trunk in
    the reverse is the kernels' choice, not work the function needs);
    ``trajectory`` one row forward; ``apg_solve`` iters + 2 gradients and
    iters K-candidate rollouts."""
    H, f = int(b.time_steps.shape[0]), trunk_flops(b)
    vg = P * H * 2 * f
    cands = K * P * H * f
    return {"value_batch": cands, "value_and_grad": vg, "trajectory": H * f,
            "apg_solve": (iters + 2) * vg + iters * cands}[kind]


def io_bytes(b, kind: str, P: int = 1, K: int = 1, n_consts: int = 0) -> int:
    """Bytes one call must move: the consts buffer, the plans (nZ wide) and
    the (H, P, 13) Brownian block read once, the outputs written once."""
    H, nZ = int(b.time_steps.shape[0]), int(b.lb_z.shape[0])
    noise = H * P * 13 if P > 1 else 0
    pre = H * nZ if b.precond is not None else 0
    io = {"value_batch": K * H * nZ + K, "value_and_grad": 2 * H * nZ + 1,
          "trajectory": H * nZ + (H + 1) * 13,
          "apg_solve": 2 * H * nZ + 1 + pre + 8 + (H + 1) * 13}[kind]
    return 4 * (n_consts + noise + io)


def bound(b, kind: str, n_consts: int, **shape) -> tuple:
    """(bound_ms, bound_by): the larger of the call's FLOPs over the fp32
    peak and its bytes over the HBM rate."""
    t_ops = work(b, kind, **{k: v for k, v in shape.items() if k in ("P", "K", "iters")})
    t_ops = t_ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = io_bytes(b, kind, n_consts=n_consts,
                       **{k: v for k, v in shape.items() if k in ("P", "K")}) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_bundle(name: str, dev):
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile

    return load_mpc_from_cfgfile(os.path.join(ROOT, f"configs/{name}.yaml"), device=dev)[3]


def n_consts(b, dev, constrained: bool = False) -> int:
    """Floats in the consts buffer of b's solves."""
    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_problem
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    x0, x_ref, u_prev, _ = constrained_problem(b) if constrained else problem(b, dev)
    return build_consts(b.model, b.params, b.cost_params, None, b.time_steps, x0, x_ref,
                        u_prev)[1].n_consts


def smem_bytes(b, dev, P: int = 1, K: int = 64) -> dict:
    """Shared memory per block of each kernel for b's constrained solves at
    P particles (the chunk each picks), and the value_batch tile."""
    import ctypes

    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_problem
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    x0, x_ref, u_prev, _ = constrained_problem(b)
    _, a = build_consts(b.model, b.params, b.cost_params, b.apg_config, b.time_steps, x0,
                        x_ref, u_prev, b.lb_z, b.ub_z)
    lib, olib = AK.load_apg_library(), CO.load_oracle_library()
    _, o = build_consts(b.model, b.params, b.cost_params, None, b.time_steps, x0, x_ref,
                        u_prev)
    if P > 1:
        AK.plan_solve_particles(a, P, 0)
        CO.plan_oracle_particles(olib, o, P, 0)
    return {"apg_solve": lib.apg_smem_bytes(ctypes.byref(a)), "apg_Pc": a.Pc,
            "apg_cluster": (a.cluster, a.chunks_per_block),
            "value_batch": olib.value_batch_smem_bytes(ctypes.byref(o), K),
            "value_and_grad": olib.value_and_grad_smem_bytes(ctypes.byref(o)),
            "trajectory": olib.trajectory_smem_bytes(ctypes.byref(o)), "oracle_Pc": o.Pc,
            "oracle_cluster": (o.cluster, o.chunks_per_block)}


def phase_constraint_parity(dev) -> dict:
    """Every state-constraint branch of every kernel against its plain
    version on the card: the whole solve (max_iter 10 from a bound-violating
    start) and the oracle (``value``, ``value_batch`` K = 4 and 64,
    ``value_and_grad``, ``trajectory`` at nZ = 10) in both forms at P=1 and
    at P=8 in chunks of 4; then the noise-robustness floor at P=128
    antithetic, a fixed 5-iteration solve, with the same torch draws.
    Returns max |err| per (kernel, form, P) and the shared memory."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    err, smem = {}, {}
    for form in SC_FORMS:
        b = make_mpc_from_config(constrained_config(form), device=dev)[3]
        x0, x_ref, u_prev, z_init = constrained_problem(b)
        m = b.cost_params.n_slack
        apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
        for P, chunk in ((1, 0), (8, 4)):
            z = None if P == 1 else brownian(P, dev, antithetic=True)
            tag = f"{form} nZ={4 + m} P={P}" + (f" chunk={chunk}" if chunk else "")
            args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev,
                    z, P, b.lb_z, b.ub_z, z_init)
            du, dx, _ = particle_solve_parity(AK, b, args, chunk, tag, "constrained solve")
            err[("apg_solve", form, P)] = du
            oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, z, P,
                     b.apg_config.maxls)
            kern = CO.cost_oracle(*oargs, chunk=chunk)
            plain = CO.cost_oracle_plain(*oargs, chunk=chunk)
            e = {"value_batch": 0.0, "value_and_grad": 0.0}
            for K in ((4, 64, 256) if P == 1 else (4,)):
                U = constrained_plans(b, K, K + P)
                for k, v in particle_oracle_parity(kern, plain, U, tag,
                                                   "constrained oracle").items():
                    e[k] = max(e[k], v)
            if P > 1:
                batch_cluster_vs_one(kern, CO.cost_oracle(*oargs, chunk=chunk, cluster=1),
                                     U, tag)
            for k, v in e.items():
                err[(k, form, P)] = v
            u = constrained_plans(b, 1, 9)[0]
            x_k, x_p = kern.trajectory(u), plain.trajectory(u)
            dxt = float((x_k - x_p).abs().max())
            err[("trajectory", form, P)] = dxt
            log(f"constrained oracle {tag}: trajectory of a {4 + m}-column plan max|dx| "
                f"{dxt:.3e} (rtol 1e-5, atol 1e-6)")
            if not torch.allclose(x_k, x_p, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"trajectory disagrees with its plain version ({tag})")
        smem[form] = smem_bytes(b, dev)
        log(f"shared memory, {form} form (nZ={4 + m}, P=1): apg_smem_bytes "
            f"{smem[form]['apg_solve']} (default budget 49152, constrained forms up to "
            f"{AK.SMEM_LIMIT_PARTICLES}); value_batch K=64 {smem[form]['value_batch']}, "
            f"value_and_grad {smem[form]['value_and_grad']}, trajectory "
            f"{smem[form]['trajectory']} (budget 49152)")

    b = floor_mpc(floor_config(), dev)[3]
    x0, x_ref, u_prev, z_init = constrained_problem(b)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev,
            brownian(P_FLOOR, dev, antithetic=True, seed=1), P_FLOOR, b.lb_z, b.ub_z, z_init)
    tag = f"altitude floor (penalty) P={P_FLOOR} antithetic"
    du, dx, steps = particle_solve_parity(AK, b, args, 0, tag, "constrained solve")
    err[("apg_solve", "penalty", P_FLOOR)] = du
    oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, args[8],
             P_FLOOR, b.apg_config.maxls)
    kern, one = CO.cost_oracle(*oargs), CO.cost_oracle(*oargs, cluster=1)
    U = plans(4, 5, dev)
    e = particle_oracle_parity(kern, CO.cost_oracle_plain(*oargs), U, tag, "constrained oracle")
    err[("value_batch", "penalty", P_FLOOR)] = e["value_batch"]
    for Ub in (U[:1], U):
        batch_cluster_vs_one(kern, one, Ub, tag)
    smem["floor"] = smem_bytes(b, dev, P_FLOOR, K=1)
    timed = time_fixed(AK, args, None, n_kernel=5, n_plain=2)
    log(f"fixed 5-iteration floor solve at P={P_FLOOR}: kernel {timed[0]:.3f} ms (CUDA "
        f"events, mean of 5, solve + trajectory), plain {timed[1]:.3f} ms (wall, mean of 2); "
        f"whole solve Pc={smem['floor']['apg_Pc']}, apg_smem_bytes {smem['floor']['apg_solve']}, "
        f"(cluster, chunks per block) {smem['floor']['apg_cluster']}; value_and_grad "
        f"{smem['floor']['oracle_cluster']}")
    return {"err": err, "smem": smem, "floor": (timed, steps, b)}


def flight(cfg: dict, dev, n: int) -> dict:
    """``examples/constrained_mpc.py`` on the port: ``n`` chained ticks of
    a 3 m position step (NED x) from hover, ``x = x_evol[1]``; the peak
    |v| and |omega| along the predicted paths, the final position error,
    wall ms and iterations per solve."""
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    x = hover_state(dev)
    target = hover_state(dev)
    target[0] = 3.0
    xdes = ned2enu(target)
    gen = torch.Generator().manual_seed(0)
    st = reset_fn(x, gen, x)
    v_max = w_max = 0.0
    wall, steps = [], []
    for _ in range(n):
        t = time.perf_counter()
        u, st, gen, x_evol = mpc_fn(x, gen, st, 0.0, xdes)
        xe = x_evol.cpu()
        wall.append((time.perf_counter() - t) * 1e3)
        steps.append(int(st.num_steps))
        if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(xe).all())):
            raise AssertionError("a constrained flight solve returned non-finite values")
        v_max = max(v_max, float(xe[1:, 3:6].abs().max()))
        w_max = max(w_max, float(xe[1:, 10:13].abs().max()))
        x = x_evol[1]
    return {"v": v_max, "w": w_max, "err": float(torch.linalg.norm(x[:3] - target[:3])),
            "wall": wall, "steps": steps}


def phase_constrained_flight(dev, card: str) -> dict:
    """The full-width constrained route: the 3 m step flown without and with
    the shipped proximal block (gate: the example's PASS), and in the
    penalty form; one ``apg_solve`` per tick and no ``trajectory`` (P=1
    exports ``x_evol``). Then the shipped config as the controller's
    position config, the floor route at P=128 through ``mpc_fn``, and the
    fixed 10-iteration solve, kernel against plain."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.engine.controller import RecedingHorizonController
    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_problem
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    n, warm = FLIGHT_TICKS, 1
    none = {"value_batch": 0, "value_and_grad": 0, "trajectory": 0}
    unconstrained = config(SHIPPED)
    unconstrained.pop("state_constr")
    runs, out = {}, {"launches": {}}
    for name, cfg in (("unconstrained", unconstrained), ("prox", constrained_config("prox")),
                      ("penalty", constrained_config("penalty"))):
        events = []
        zero_counts()
        with routed("apg_solve_kernel", event_timed(events)):
            r = flight(cfg, dev, n)
        torch.cuda.synchronize()
        out["launches"][name] = check_route(f"constrained flight ({name})",
                                            {"apg_solve": n, **none})
        r["device"] = [a.elapsed_time(e) for a, e in events]
        runs[name] = r
        log(f"3 m step, {name} ({n} chained ticks, {card}): |v|max {r['v']:.3f} m/s, "
            f"|w|max {r['w']:.3f} rad/s, final error {r['err']:.3f} m; per solve p50 "
            f"{statistics.median(r['wall'][warm:]):.3f} ms wall, "
            f"{statistics.median(r['device'][warm:]):.3f} ms device span over ticks "
            f"{warm + 1}-{n}; iterations per solve mean {statistics.mean(r['steps']):.1f} "
            f"(min {min(r['steps'])}, max {max(r['steps'])})")
    v_u, v_c = runs["unconstrained"]["v"], runs["prox"]["v"]
    ok = v_c < v_u and v_c < 0.75
    log(f"constrained flight (examples/constrained_mpc.py gate: v_c < v_u and v_c < 0.75 "
        f"m/s): v_u {v_u:.3f}, v_c {v_c:.3f} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the constrained flight did not hold its velocity box")
    out["runs"] = runs

    # the shipped config as the position config of the controller
    c = RecedingHorizonController(os.path.join(ROOT, "configs/iris_traj_mpc.yaml"),
                                  os.path.join(ROOT, f"configs/{SHIPPED}.yaml"),
                                  seed=0, now_fn=lambda: 0.0, device=dev)
    pos0 = c.pos.solves
    zero_counts()
    cmds, _ = G.replay_pos(c)
    torch.cuda.synchronize()
    n_pos = c.pos.solves - pos0
    check_route("constrained controller", {"apg_solve": n_pos, **none})
    log(f"RecedingHorizonController with {SHIPPED} as its position config: {n_pos} pos "
        f"solves, commands u0 {np.array2string(cmds[-1, :4], precision=4)}, slack columns "
        f"{tuple(c.opt_state_pos.yk.shape)} kept in its warm start")
    if not (n_pos == 6 and np.isfinite(cmds).all() and (cmds[:, :4] >= 1e-4 - 1e-7).all()
            and (cmds[:, :4] <= 1.0 + 1e-7).all() and c.opt_state_pos.yk.shape[1] == 10):
        raise AssertionError("the controller did not fly the constrained position config")

    # the particle route of examples/noise_robustness.py
    zero_counts()
    rows, ms = chain(floor_config(), dev, 3, make=floor_mpc)
    torch.cuda.synchronize()
    out["launches"]["floor"] = check_route(f"floor P={P_FLOOR}", {
        "apg_solve": 3, "value_batch": 0, "value_and_grad": 0, "trajectory": 3})
    out["floor_ms"] = ms
    log(f"altitude-floor route at P={P_FLOOR} antithetic through mpc_fn ({card}): 3 chained "
        f"solves at {rows[:, -1].tolist()} iterations, "
        f"{np.array2string(np.array(ms), precision=1)} ms wall")
    if not (np.isfinite(rows).all() and (rows[:, -1] >= 1).all()):
        raise AssertionError(f"the floor route at P={P_FLOOR} returned an invalid plan")

    # the fixed 10-iteration solve of each form, kernel against plain
    out["fixed"], out["fixed_steps"] = {}, {}
    for form in SC_FORMS:
        b = make_mpc_from_config(constrained_config(form), device=dev)[3]
        x0, x_ref, u_prev, z_init = constrained_problem(b)
        apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
        args = (b.model, b.params, b.cost_params, apg, b.time_steps, x0, x_ref, u_prev, None,
                1, b.lb_z, b.ub_z, z_init)
        out["fixed"][form] = (time_fixed(AK, args, None), b)
        k_ms, p_ms = out["fixed"][form][0]
        steps = int(AK.apg_solve_kernel(*args)[0].num_steps)
        out["fixed_steps"][form] = steps
        log(f"fixed 10-iteration {form} solve ({card}): kernel {k_ms:.4f} ms (CUDA events, "
            f"mean of 20; {k_ms / steps:.4f} ms per iteration at {steps}), plain "
            f"{p_ms:.3f} ms (wall, mean of 3)")
    return out


def phase_constrained_oracle(dev, card: str) -> dict:
    """The oracle routes with state constraints: MPPI on the constrained
    config at the MPPIConfig defaults (kernels vs plain with the same torch
    draws, |du| <= 1e-4 per row), fixed-step APG (kernels vs plain in
    lockstep), in both forms, and fixed-step at P=128 on the floor (the
    oracle's constrained particle branches, then those kernels against
    plain); launch counts per route; per-launch times."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.solver.apg import apg_solve

    n, iters, step = 4, 8, 1e-6
    out = {"launches": {}, "err": {}, "ms": {}}
    for form in SC_FORMS:
        zero_counts()
        rows_k, _ = chain(constrained_config(form, solver="mppi"), dev, n)
        torch.cuda.synchronize()
        out["launches"][("mppi", form)] = check_route(f"constrained MPPI ({form})", {
            "apg_solve": 0, "value_batch": n * (iters + 2), "value_and_grad": 0,
            "trajectory": n})
        with routed("cost_oracle", CO.cost_oracle_plain):
            rows_p, _ = chain(constrained_config(form, solver="mppi"), dev, n)
        du = np.abs(rows_k[:, :-1] - rows_p[:, :-1]).max(axis=1)
        log(f"constrained MPPI ({form}; K=64, {iters} rounds, {n} chained solves), kernels vs "
            f"plain, same draws: max|du| per row {np.array2string(du, precision=3)} (gate 1e-4)")
        if not ((du <= 1e-4).all() and np.isfinite(rows_k).all()):
            raise AssertionError(f"constrained MPPI through the kernels disagrees ({form})")

        cfg = constrained_config(form, linesearch=None, stepsize=step, max_iter=30,
                                 max_no_improvement_iter=30)
        zero_counts()
        rows, _ = chain(cfg, dev, 2)
        torch.cuda.synchronize()
        k = int(rows[:, -1].sum())
        out["launches"][("fixed_step", form)] = check_route(f"constrained fixed-step ({form})", {
            "apg_solve": 0, "value_batch": k, "value_and_grad": k + 4, "trajectory": 2})
        b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)[3]
        x0, x_ref, u_prev, z_init = constrained_problem(b)
        oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev, None, 1,
                 b.apg_config.maxls)
        kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
        with torch.no_grad():
            st_k, st_p = (apg_solve(o, z_init, b.lb_z, b.ub_z, b.apg_config)
                          for o in (kern, plain))
        nk, np_ = int(st_k.num_steps), int(st_p.num_steps)
        du = float((st_k.yk - st_p.yk).abs().max())
        dc = abs(float(st_k.opt_cost) - float(st_p.opt_cost)) / abs(float(st_p.opt_cost))
        log(f"constrained fixed-step ({form}, stepsize {step}, 30 iterations): steps kernel "
            f"{nk} plain {np_}; max|du| {du:.3e} (rtol 5e-4, atol 5e-5); cost "
            f"{float(st_p.init_cost):.3f} -> {float(st_k.opt_cost):.3f}, rel {dc:.3e}")
        if not (nk == np_ and torch.allclose(st_k.yk, st_p.yk, rtol=5e-4, atol=5e-5)
                and dc <= 5e-4 and float(st_k.opt_cost) < float(st_k.init_cost)):
            raise AssertionError(f"constrained fixed-step APG disagrees on the kernels ({form})")
        out["err"][("fixed_step", form)] = du
        m = b.cost_params.n_slack
        U, u = constrained_plans(b, 64, 1), constrained_plans(b, 1, 2)[0]
        for name, call in (("value_batch", lambda o: o.value_batch(U)),
                           ("value_and_grad", lambda o: o.value_and_grad(u)),
                           ("trajectory", lambda o: o.trajectory(u))):
            out["ms"][(name, form, 1)] = (per_launch_ms(lambda: call(kern), 50),
                                          per_launch_ms(lambda: call(plain), 5))
            log(f"{name}{' K=64' if name == 'value_batch' else ''} {form} nZ={4 + m} per "
                f"launch ({card}): kernel {out['ms'][(name, form, 1)][0]:.4f} ms, plain "
                f"{out['ms'][(name, form, 1)][1]:.3f} ms (CUDA events)")

    cfg = floor_config(linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"], max_iter=20)
    zero_counts()
    rows, ms = chain(cfg, dev, 2, make=floor_mpc)
    torch.cuda.synchronize()
    k = int(rows[:, -1].sum())
    out["launches"][("fixed_step", "floor")] = check_route(f"floor fixed-step P={P_FLOOR}", {
        "apg_solve": 0, "value_batch": k, "value_and_grad": k + 4, "trajectory": 2})
    out["floor_iteration_ms"] = statistics.median(m / max(k, 1) for m, k in zip(ms, rows[:, -1]))
    log(f"floor fixed-step route at P={P_FLOOR}: 2 chained solves at "
        f"{rows[:, -1].tolist()} iterations, {np.array2string(np.array(ms), precision=1)} ms "
        f"({out['floor_iteration_ms']:.3f} ms wall per iteration p50)")
    b = floor_mpc(cfg, dev)[3]
    x0, x_ref, u_prev, _ = constrained_problem(b)
    oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
             brownian(P_FLOOR, dev, antithetic=True, seed=2), P_FLOOR, b.apg_config.maxls)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    U, u = plans(4, 3, dev), plans(1, 4, dev)[0]
    for name, e in particle_oracle_parity(kern, plain, U, f"floor P={P_FLOOR} antithetic",
                                          "constrained oracle").items():
        out["err"][(name, "floor")] = e
    for name, call in (("value_batch", lambda o: o.value_batch(U[:1])),
                       ("value_and_grad", lambda o: o.value_and_grad(u))):
        out["ms"][(name, "penalty", P_FLOOR)] = (per_launch_ms(lambda: call(kern), 20),
                                                 per_launch_ms(lambda: call(plain), 3))
        log(f"{name}{' K=1' if name == 'value_batch' else ''} floor at P={P_FLOOR} per launch "
            f"({card}): kernel {out['ms'][(name, 'penalty', P_FLOOR)][0]:.4f} ms, plain "
            f"{out['ms'][(name, 'penalty', P_FLOOR)][1]:.3f} ms (CUDA events)")
    out["floor_bundle"] = b
    return out


def p1_smem(dev) -> dict:
    """Shared memory per block of the P=1 forms at n_u = 4 (iris) and n_u = 6
    (hexa): the whole solve against the 48 KB its launch check allows
    (``apg_solve.cu::launch_ok``), the oracle kernels at their tiles."""
    import ctypes

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    lib, olib = AK.load_apg_library(), CO.load_oracle_library()
    out = {}
    for vehicle in VEHICLES:
        b = make_bundle(f"{vehicle}_traj_mpc", dev)
        x0, x_ref, u_prev, _ = problem(b, dev)
        _, a = build_consts(b.model, b.params, b.cost_params, b.apg_config, b.time_steps, x0,
                            x_ref, u_prev, b.lb, b.ub, has_pre=b.precond is not None)
        _, o = build_consts(b.model, b.params, b.cost_params, None, b.time_steps, x0, x_ref,
                            u_prev)
        out[vehicle] = {"n_u": b.model.n_u, "F": a.F,
                        "apg_solve": lib.apg_smem_bytes(ctypes.byref(a)),
                        "value_batch_K64": olib.value_batch_smem_bytes(ctypes.byref(o), 64),
                        "value_and_grad": olib.value_and_grad_smem_bytes(ctypes.byref(o)),
                        "trajectory": olib.trajectory_smem_bytes(ctypes.byref(o))}
        log(f"phase 2: shared memory of the P=1 forms, {vehicle} (n_u = {b.model.n_u}, "
            f"F = {a.F}): {out[vehicle]} (whole solve budget {AK.SMEM_LIMIT} B)")
        if out[vehicle]["apg_solve"] > AK.SMEM_LIMIT:
            raise AssertionError(f"the P=1 whole solve of {vehicle} needs more than 48 KB")
    return out


def phase_hexa(dev, card: str) -> dict:
    """The hexa airframe (n_u = 6, F = 15) on every kernel: the oracle at
    the phase-4 tolerances (``value_batch`` K = 1, 9, 64 on the register
    chain, ``value_and_grad``, ``trajectory``), the fixed 10-iteration traj
    solve and the fixed 5-iteration P=512 antithetic solve (with its
    ``trajectory`` launch) kernel against plain, the three hexa goldens
    (the engagement's cost printed, not gated), then the chained hexa
    replays' per-solve wall time p50 and iterations."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    out = {"err": {"value_batch": 0.0, "value_and_grad": 0.0, "trajectory": 0.0}}
    b, kern, plain = oracles("hexa_traj_mpc", dev)
    n_u = b.model.n_u
    for K in (1, 9, 64):
        U = plans(K, K, dev, n_u)
        n0 = CO.value_batch_kernel.launches
        vk = kern.value_batch(U)
        torch.cuda.synchronize()
        vp = plain.value_batch(U)
        rel = float(((vk - vp).abs() / vp.abs()).max())
        out["err"]["value_batch"] = max(out["err"]["value_batch"], float((vk - vp).abs().max()))
        log(f"oracle hexa_traj_mpc (n_u = {n_u}): value_batch K={K} max rel err {rel:.3e} "
            f"(rtol 2e-5)")
        if not (rel <= 2e-5 and bool(torch.isfinite(vk).all())
                and CO.value_batch_kernel.launches == n0 + 1):
            raise AssertionError(f"value_batch disagrees with its plain version (hexa, K={K})")
    u = plans(1, 7, dev, n_u)[0]
    (v_k, g_k), (v_p, g_p) = kern.value_and_grad(u), plain.value_and_grad(u)
    x_k, x_p = kern.trajectory(u), plain.trajectory(u)
    torch.cuda.synchronize()
    dv = abs(float(v_k) - float(v_p)) / abs(float(v_p))
    dg, dx = float((g_k - g_p).abs().max()), float((x_k - x_p).abs().max())
    out["err"]["value_and_grad"] = max(dg, abs(float(v_k - v_p)))
    out["err"]["trajectory"] = dx
    log(f"oracle hexa_traj_mpc: value_and_grad value rel {dv:.3e} (rtol 2e-5), grad max|d| "
        f"{dg:.3e} (rtol 5e-4, atol 5e-5; motors 5-6 max|g| "
        f"{float(g_k[:, 4:].abs().max()):.3e}); trajectory max|dx| {dx:.3e} (rtol 1e-5)")
    if not (dv <= 2e-5 and torch.allclose(g_k, g_p, rtol=5e-4, atol=5e-5)
            and torch.allclose(x_k, x_p, rtol=1e-5, atol=1e-6)
            and float(g_k[:, 4:].abs().max()) > 0):
        raise AssertionError("an oracle kernel disagrees with its plain version (hexa)")
    log(f"value_batch rows per block by K, hexa trunk: {check_grid(b, b.params, dev)}")

    out["solve_err"], out["fixed"] = phase_parity(dev, HEXA_TOLS)
    # the fixed 5-iteration P=512 antithetic solve, for parity only
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    bp = make_mpc_from_config(config("hexa_traj_mpc", particles=P_FULL), device=dev)[3]
    x0, x_ref, u_prev, u_init = problem(bp, dev)
    apg = bp.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    z = brownian(P_FULL, dev, antithetic=True, seed=0)
    args = (bp.model, bp.params, bp.cost_params, apg, bp.time_steps, x0, x_ref, u_prev, z,
            P_FULL, bp.lb, bp.ub, u_init)
    n0 = counts()
    du, dxp, steps = particle_solve_parity(AK, bp, args, 0,
                                           f"hexa_traj_mpc P={P_FULL} antithetic",
                                           fp32_spread=True)
    n1 = counts()
    if (n1["apg_solve"] - n0["apg_solve"], n1["trajectory"] - n0["trajectory"]) != (1, 1):
        raise AssertionError(f"the hexa P={P_FULL} solve did not launch apg_solve and "
                             f"trajectory once each: {n0} -> {n1}")
    out["p512"] = {"max_du": du, "max_dx": dxp, "steps": steps}
    out["p512"]["ms"], out["p512"]["plain_ms"] = time_fixed(AK, args, bp.precond, n_kernel=5,
                                                            n_plain=2)
    log(f"fixed 5-iteration hexa P={P_FULL} traj solve ({card}): kernel "
        f"{out['p512']['ms']:.3f} ms (CUDA events, mean of 5, solve + trajectory), plain "
        f"{out['p512']['plain_ms']:.3f} ms (wall, mean of 2)")

    out["launches"] = phase_slice(dev, "hexa")
    for mode in ("pos", "traj"):
        k_ms, k_steps, ticks = chained(dev, mode, 6, 1, "hexa")
        out[mode] = (k_ms, k_steps, ticks)
        log(f"chained hexa/{mode} replay, per solve p50 ({card}): kernel {k_ms:.3f} ms wall "
            f"at {k_steps:.1f} iterations over ticks 2-6 (iterations {ticks})")
    return out


def free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_closed_loop(dev, card: str) -> dict:
    """The port's closed loop (``sim/closed_loop.py``: the engine node on the
    card, pipeline on, the plant on the host CPU, UDP MAVLink between them)
    at time-scale 1 for ``CLOSED_LOOP_S`` s: iris and hexa gated at the
    example's PASS (mean error < 0.35 m over t_traj > 3 s, FCU ``MPC_ON``),
    iris at P=512 antithetic without and with the reference's 30 ms
    iteration budget (``--deadline-ms 30``) printed. The launch counts are
    zeroed before
    each run (the engine's warm solves included) and read after."""
    import torch

    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    runs = {}
    p512 = ["--particles", str(P_FULL)]
    for tag, argv, gated in (("iris", [], True), ("hexa", ["--vehicle", "hexa"], True),
                             (f"iris P={P_FULL}", p512, False),
                             (f"iris P={P_FULL} deadline 30 ms", p512 + ["--deadline-ms", "30"],
                              False)):
        zero_counts()
        res = closed_loop.run(["--seconds", str(CLOSED_LOOP_S), "--time-scale", "1"] + argv)
        torch.cuda.synchronize()
        got = counts()
        res["launches"] = got
        runs[tag] = res
        log(f"closed loop {tag} ({card}, engine on {res['device']}, pipeline "
            f"{res['pipeline']}, {res['seconds']} s at time-scale 1 in {res['wall_s']:.2f} s "
            f"wall, engine built in {res['build_s']:.2f} s): tracking error mean "
            f"{res['err_mean_m']:.4f} m max {res['err_max_m']:.4f} m over {res['err_ticks']} "
            f"ticks; FCU status {res['fcu_status']}; watchdog trips {res['watchdog_trips']}; "
            f"timeout ticks {res['timeout_ticks']}/{res['tracked_ticks']} "
            f"({100 * res['timeout_frac']:.1f} %); max pickup idx {res['max_pickup_idx']} "
            f"(overruns {res['overruns']}); {res['solves']} solves, p50 "
            f"{res['solve_ms_p50']:.3f} ms (max {res['solve_ms_max']:.3f}) at "
            f"{res['iterations_p50']} iterations (first {res['first_iterations']}); ingress "
            f"pick p50 {res['pick_ms_p50']:.4f} ms p99 {res['pick_ms_p99']:.4f} ms over "
            f"{res['picks']}; mailbox {res['mailbox']}, codec {res['codec']}; kernel "
            f"launches {got} -> {'PASS' if res['ok'] else 'FAIL'}"
            f"{'' if gated else ' (printed, not gated)'}")
        particles = "--particles" in argv
        if (got["apg_solve"] < 1 or got["value_batch"] or got["value_and_grad"]
                or (got["trajectory"] < 1 if particles else got["trajectory"])):
            raise AssertionError(f"the closed loop {tag} did not run on the kernels it needs")
        if "jax" in sys.modules:
            raise AssertionError("JAX was imported")
        if gated and not res["ok"]:
            raise AssertionError(f"the closed loop {tag} failed its PASS gate: {res}")
    return runs


def phase_launch_tier(card: str) -> dict:
    """The launch tier: ``fcu_sim`` (iris) and ``sde_control`` as two fresh
    processes through ``python -m sde4mbrl_px4_tpu_torch.launch``, on the
    shipped launch files with free UDP ports. Gates: both print READY within
    ``LAUNCH_READY_S``; after ``initialize_mpc``, the traj idle mode and the
    motor passthrough are set over ``EngineServiceClient`` the FCU reports
    ``MPC_ON`` within ``LAUNCH_ON_S``; after ``CTRL_TRAJ_ACTIVE`` the
    engine reports the traj mode and the FCU stays ``MPC_ON``; both exit
    0 on SIGTERM."""
    import queue
    import threading

    import yaml

    from sde4mbrl_px4_tpu_torch.core.types import CTRL_TRAJ_ACTIVE, CTRL_TRAJ_IDLE
    from sde4mbrl_px4_tpu_torch.io.engine_runtime import EngineServiceClient

    d = os.path.join(ROOT, "build", "chip_smoke", "launch")
    os.makedirs(d, exist_ok=True)
    mav, svc = free_udp_port(), free_udp_port()
    files = {}
    for key, name in (("fcu_sim", "iris_px4_sitl.yaml"), ("sde_control", "iris_sdectrl.yaml")):
        with open(os.path.join(ROOT, "configs", "launch", name)) as f:
            cfg = yaml.safe_load(f)
        cfg.update(addr_mavlink_state_msg=f"127.0.0.1:{mav}", addr_services=f"127.0.0.1:{svc}",
                   config_dir=os.path.join(ROOT, "configs"))
        files[key] = os.path.join(d, name)
        with open(files[key], "w") as f:
            yaml.safe_dump(cfg, f)
    lines: "queue.Queue" = queue.Queue()
    procs, logs = {}, {k: [] for k in files}

    def pump(key, proc):
        for line in proc.stdout:
            logs[key].append(line.rstrip())
            lines.put((key, line.rstrip()))

    def wait_for(pred, seconds: float, what: str) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                key, line = lines.get(timeout=0.5)
            except queue.Empty:
                if any(p.poll() is not None for p in procs.values()):
                    break
                continue
            if pred(key, line):
                return time.perf_counter() - t0
        tails = {k: v[-15:] for k, v in logs.items()}
        raise AssertionError(f"the launch tier: no {what} within {seconds} s; {tails}")

    t_start = time.perf_counter()
    out = {}
    try:
        for key in ("sde_control", "fcu_sim"):
            procs[key] = subprocess.Popen(
                [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", files[key]],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                bufsize=1)
            threading.Thread(target=pump, args=(key, procs[key]), daemon=True).start()
        ready = set()

        def is_ready(key, line):
            if "[launch] READY" in line:
                ready.add(key)
            return ready == set(procs)

        wait_for(is_ready, LAUNCH_READY_S, "READY from both nodes")
        out["ready_s"] = time.perf_counter() - t_start
        log(f"launch tier: both nodes READY {out['ready_s']:.2f} s after their start")
        cli = EngineServiceClient(f"127.0.0.1:{svc}", timeout=5.0)
        try:
            t_cmd = time.perf_counter()
            if not cli.initialize_mpc():
                raise AssertionError("the launch tier: initialize_mpc refused")
            for mode, kw in ((CTRL_TRAJ_IDLE, {}), (0, {"weight_motors": 100})):
                ok, msg = cli.set_mode(mode, **kw)
                if not ok:
                    raise AssertionError(f"the launch tier: set_mode {mode} refused: {msg}")
            on = "status=1"     # FCUSim.MPC_ON
            wait_for(lambda k, line: k == "fcu_sim" and on in line, LAUNCH_ON_S,
                     "FCU MPC_ON after the traj idle mode")
            out["mpc_on_s"] = time.perf_counter() - t_cmd
            ok, msg = cli.set_mode(CTRL_TRAJ_ACTIVE)
            if not (ok and "started" in msg):
                raise AssertionError(f"the launch tier: CTRL_TRAJ_ACTIVE refused: {msg}")
            time.sleep(3.0)
            rec = cli.status()
            n_on = sum(1 for line in logs["fcu_sim"][-3:] if on in line)
            out.update(state=rec.get("ctrl_state"), num_steps=rec.get("num_steps"),
                       solve_ms=1e3 * float(rec.get("solve_time", 0.0)),
                       mpc_indx=rec.get("mpc_indx"), fcu_tail=logs["fcu_sim"][-3:])
            log(f"launch tier ({card}): FCU MPC_ON {out['mpc_on_s']:.2f} s after "
                f"initialize_mpc; 3 s after CTRL_TRAJ_ACTIVE the engine reports state "
                f"{out['state']}, {out['num_steps']} iterations, solve {out['solve_ms']:.3f} "
                f"ms, pickup idx {out['mpc_indx']}; the FCU's last lines {out['fcu_tail']}")
            if out["state"] != "traj" or n_on < 2:
                raise AssertionError(f"the launch tier did not fly the trajectory: {out}")
        finally:
            cli.close()
    finally:
        for key, proc in procs.items():
            if proc.poll() is None:
                proc.terminate()
        for key, proc in procs.items():
            try:
                out[f"{key}_rc"] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                out[f"{key}_rc"] = proc.wait(timeout=30)
    log(f"launch tier: exit codes after SIGTERM: engine {out['sde_control_rc']}, fcu_sim "
        f"{out['fcu_sim_rc']}")
    if out["sde_control_rc"] != 0 or out["fcu_sim_rc"] != 0:
        raise AssertionError(f"a launch-tier node did not stop cleanly: {out}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy

    apply_fp32_policy()
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    smem = p1_smem(dev)
    max_err, fixed = phase_parity(dev)
    log(f"phase 3: the whole-solve kernel matches its plain version (max|du| {max_err:.3e})")
    oracle_err = phase_oracle_parity(dev)
    log(f"phase 4: the oracle kernels match the plain oracle (max|err| {oracle_err})")
    fs_err = phase_fixed_step_parity(dev)
    log(f"phase 5: fixed-step APG on the kernels matches plain (max|du| {fs_err:.3e})")
    launches = {"apg_solve": phase_slice(dev)}
    log("phase 6: the whole-solve route passes the golden gates through the kernel")
    mppi = phase_mppi(dev)
    log("phase 7: the MPPI route runs on the oracle kernels and closes the loop")
    fixed_route = phase_fixed_step(dev)
    log("phase 8: the fixed-step route runs on the oracle kernels")
    launches.update(value_batch=mppi["value_batch"], trajectory=mppi["trajectory"],
                    value_and_grad=fixed_route["value_and_grad"])
    timing = phase_timing(dev, card)
    log("phase 9: timed")
    part_err = phase_particle_parity(dev)
    log(f"phase 10: the particle branches match their plain versions (max|err| {part_err})")
    family_launches, family_du = phase_particle_family(dev)
    part_err["apg_solve"] = max(part_err["apg_solve"], family_du)
    log("phase 11: the p512anti family replays kernel vs plain within 5e-4")
    flight = phase_particle_flight(dev, card)
    part_err["apg_solve"] = max(part_err["apg_solve"], flight["max_du"])
    log(f"phase 12: the P={P_FULL} antithetic route flies on the particle kernels")
    part_oracle = phase_particle_oracle(dev, card)
    for kernel, e in part_oracle["err"].items():
        part_err[kernel] = max(part_err[kernel], e)
    log(f"phase 13: the fixed-step route at P={P_FULL} runs on the particle oracle kernels, "
        f"which match the plain oracle there")

    cons = phase_constraint_parity(dev)
    log("phase 14: every state-constraint branch matches its plain version")
    cflight = phase_constrained_flight(dev, card)
    log("phase 15: the constrained flight holds its velocity box on the whole-solve kernel")
    coracle = phase_constrained_oracle(dev, card)
    log("phase 16: MPPI and fixed-step APG with state constraints run on the oracle kernels, "
        "which match the plain oracle there")
    hexa = phase_hexa(dev, card)
    log("phase 17: the hexa airframe (n_u = 6) matches the plain versions on every kernel "
        "and passes its golden gates")
    loops = phase_closed_loop(dev, card)
    log("phase 18: the closed loop flies iris and hexa on the card")
    tier = phase_launch_tier(card)
    log("phase 19: the launch tier's two processes reach MPC_ON")

    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import ORACLE_P1_ROWS

    oracle_src = "sde4mbrl_px4_tpu_torch/csrc/cost_oracle.cu"
    tpu = "sde4mbrl_px4_tpu/ops/pallas/solve_kernels.py"
    apg = {"route": "cuda", "source": "sde4mbrl_px4_tpu_torch/csrc/apg_solve.cu",
           "replaces": "sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py:420"}
    lines = {"value_batch": 276, "value_and_grad": 297, "trajectory": 347}
    particles = "noise + chunks (K11)"
    b_traj, b_pos = (make_bundle(name, dev) for name in TOLS)
    nc_traj, nc_pos = n_consts(b_traj, dev), n_consts(b_pos, dev)

    def entry(name, branch, launches, err, ms, plain_ms, bnd, **extra):
        where = apg if name == "apg_solve" else {
            "route": "cuda", "source": oracle_src, "replaces": f"{tpu}:{lines[name]}"}
        return {"name": name, "branch": branch, **where, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None, **extra}

    b_hexa = make_bundle("hexa_traj_mpc", dev)
    cl_launches = {tag: run["launches"] for tag, run in loops.items()}
    kernels = [
        entry("apg_solve", "P=1", launches["apg_solve"], max_err, timing["traj"][0],
              timing["traj"][1], bound(b_traj, "apg_solve", nc_traj, K=4,
                                       iters=round(timing["traj"][3])),
              timed=f"chained iris/traj replay, per solve p50 at "
                    f"{timing['traj'][3]:.1f} iterations", device_ms=timing["traj"][2],
              iteration_ms=timing["traj"][4], pos_iteration_ms=timing["pos"][4],
              phase_split_iteration_ms=timing["split"]["iteration_ms"],
              fixed_budget_ms=fixed[0], fixed_budget_plain_ms=fixed[1],
              smem_bytes=smem["iris"]["apg_solve"],
              closed_loop_launches=cl_launches["iris"]["apg_solve"]),
        entry("apg_solve", "P=1, hexa (n_u = 6, F = 15)", hexa["launches"],
              hexa["solve_err"], hexa["fixed"][0], hexa["fixed"][1],
              bound(b_hexa, "apg_solve", n_consts(b_hexa, dev), K=4, iters=10),
              timed="fixed 10-iteration hexa traj solve", smem_bytes=smem["hexa"]["apg_solve"],
              traj_solve_ms_p50=hexa["traj"][0], traj_iterations=hexa["traj"][1],
              pos_solve_ms_p50=hexa["pos"][0], pos_iterations=hexa["pos"][1],
              closed_loop_launches=cl_launches["hexa"]["apg_solve"],
              p512_fixed_ms=hexa["p512"]["ms"], p512_fixed_plain_ms=hexa["p512"]["plain_ms"],
              p512_max_abs_err=hexa["p512"]["max_du"]),
        entry("apg_solve", particles, flight["launches"]["apg_solve"], part_err["apg_solve"],
              flight["fixed_ms"], flight["fixed_plain_ms"],
              bound(b_traj, "apg_solve", nc_traj, P=P_FULL, K=4, iters=flight["fixed_steps"]),
              timed=f"fixed {flight['fixed_steps']}-iteration solve at P={P_FULL} antithetic, "
                    f"with its trajectory launch",
              solve_ms_p50=flight["wall_ms"], device_ms_p50=flight["device_ms"],
              iterations=flight["steps"], iteration_ms=flight["iter_ms"],
              Pc=flight["Pc"], smem_bytes=flight["smem"],
              cluster=flight["cluster"]["cluster"],
              chunks_per_block=flight["cluster"]["chunks_per_block"],
              cluster_max=flight["cluster"]["c_max"],
              max_active_clusters=flight["cluster"]["max_active_clusters"],
              fixed_budget_ms_cluster_1=flight["fixed_ms_c1"],
              phase_split_iteration_ms=flight["split"]["iteration_ms"],
              p512anti_family_launches=family_launches["apg_solve"]),
    ] + [entry(name, "P=1", launches[name], oracle_err[name], timing[name][0], timing[name][1],
               bound(b_pos, name, nc_pos, K=64 if name == "value_batch" else 1),
               timed="per launch" + (", K=64" if name == "value_batch" else ""),
               hexa_max_abs_err=hexa["err"][name],
               **({"rows_per_block": ORACLE_P1_ROWS, "ms_K256": timing["value_batch_K256"][0],
                   "plain_ms_K256": timing["value_batch_K256"][1],
                   "bound_ms_K256": bound(b_pos, name, nc_pos, K=256)[0]}
                  if name == "value_batch" else {}))
         for name in ("value_batch", "value_and_grad", "trajectory")] + [
        entry(name, particles, part_oracle["launches"][name], part_err[name],
              part_oracle[name][0], part_oracle[name][1],
              bound(b_pos, name, nc_pos, P=P_FULL, K=1),
              timed=f"per launch at P={P_FULL} antithetic"
                    + (", K=1 (what the fixed-step route launches)"
                       if name == "value_batch" else ""), Pc=flight["oracle_Pc"],
              cluster=part_oracle["plan"]["cluster"],
              chunks_per_block=part_oracle["plan"]["chunks_per_block"],
              cluster_max=part_oracle["plan"][name]["c_max"],
              max_active_clusters=part_oracle["plan"][name]["max_active_clusters"],
              ms_cluster_1=part_oracle[name][2],
              **({"ms_K4": part_oracle["value_batch_K4"][0],
                  "plain_ms_K4": part_oracle["value_batch_K4"][1],
                  "ms_cluster_1_K4": part_oracle["value_batch_K4"][2],
                  "bound_ms_K4": bound(b_pos, name, nc_pos, P=P_FULL, K=4)[0],
                  "route_iterations": part_oracle["iterations"],
                  "route_iteration_ms": part_oracle["iteration_ms"]}
                 if name == "value_batch" else {"iteration_ms": part_oracle["iteration_ms"]}))
        for name in ("value_batch", "value_and_grad")] + [
        entry("trajectory", f"x_evol of the P={P_FULL} route (mean dynamics)",
              flight["launches"]["trajectory"], flight["max_dx"], timing["trajectory"][0],
              timing["trajectory"][1], bound(b_pos, "trajectory", nc_pos),
              timed="per launch, as the P=1 branch: the same kernel at the same shape",
              closed_loop_launches=cl_launches[f"iris P={P_FULL}"]["trajectory"])]

    err, smem = cons["err"], cons["smem"]
    for form in SC_FORMS:
        (k_ms, p_ms), b = cflight["fixed"][form]
        run = cflight["runs"][form]
        kernels.append(entry(
            "apg_solve", f"state_constr {form}, P=1", cflight["launches"][form]["apg_solve"],
            err[("apg_solve", form, 1)], k_ms, p_ms,
            bound(b, "apg_solve", n_consts(b, dev, True), K=4, iters=10),
            timed="fixed 10-iteration solve from the bound-violating start", form=form, P=1,
            iteration_ms=k_ms / cflight["fixed_steps"][form],
            max_abs_err_P8_chunked=err[("apg_solve", form, 8)],
            flight_solve_ms_p50=statistics.median(run["wall"][1:]),
            flight_device_ms_p50=statistics.median(run["device"][1:]),
            flight_iterations_mean=statistics.mean(run["steps"]),
            flight_v_max=run["v"], smem_bytes=smem[form]["apg_solve"]))
    (f_ms, f_plain), f_steps, b_floor = cons["floor"]
    kernels.append(entry(
        "apg_solve", f"state_constr penalty (altitude floor), P={P_FLOOR} antithetic",
        cflight["launches"]["floor"]["apg_solve"], err[("apg_solve", "penalty", P_FLOOR)],
        f_ms, f_plain, bound(b_floor, "apg_solve", n_consts(b_floor, dev, True), P=P_FLOOR,
                             K=4, iters=f_steps),
        timed=f"fixed {f_steps}-iteration solve with its trajectory launch",
        form="penalty", P=P_FLOOR,
        Pc=smem["floor"]["apg_Pc"], smem_bytes=smem["floor"]["apg_solve"],
        cluster=smem["floor"]["apg_cluster"][0],
        chunks_per_block=smem["floor"]["apg_cluster"][1], iteration_ms=f_ms / f_steps,
        solve_ms_p50=statistics.median(cflight["floor_ms"][1:])))
    for name in ("value_batch", "value_and_grad", "trajectory"):
        for form in SC_FORMS:
            b = cflight["fixed"][form][1]
            n = sum(coracle["launches"][(route, form)][name] for route in ("mppi", "fixed_step"))
            e = max(err[(name, form, 1)], err[(name, form, 8)])
            ms, plain_ms = coracle["ms"][(name, form, 1)]
            K = 64 if name == "value_batch" else 1
            if name == "trajectory" and form != "prox":
                continue                      # the same kernel: nZ = 10 is the new width
            kernels.append(entry(
                name, f"state_constr {form}, P=1" + (f", nZ=10" if form == "prox" else ""),
                n, e, ms, plain_ms, bound(b, name, n_consts(b, dev, True), K=K),
                timed="per launch" + (", K=64" if K == 64 else ""), form=form, P=1,
                smem_bytes=smem[form][name]))
        if name == "trajectory":
            continue
        ms, plain_ms = coracle["ms"][(name, "penalty", P_FLOOR)]
        b = coracle["floor_bundle"]
        kernels.append(entry(
            name, f"state_constr penalty (altitude floor), P={P_FLOOR} antithetic",
            coracle["launches"][("fixed_step", "floor")][name], coracle["err"][(name, "floor")],
            ms, plain_ms, bound(b, name, n_consts(b, dev, True), P=P_FLOOR, K=1),
            timed="per launch" + (", K=1" if name == "value_batch" else ""),
            form="penalty", P=P_FLOOR,
            Pc=smem["floor"]["oracle_Pc"], smem_bytes=smem["floor"][name],
            cluster=smem["floor"]["oracle_cluster"][0],
            chunks_per_block=smem["floor"]["oracle_cluster"][1],
            **({"iteration_ms": coracle["floor_iteration_ms"]}
               if name == "value_and_grad" else {})))
    print(json.dumps({"kernels": kernels, "solve_ms": {
        "mppi": timing["mppi"][0], "mppi_plain": timing["mppi"][1],
        "fixed_step": timing["fixed_step"][0],
        "fixed_step_plain": timing["fixed_step"][1],
        f"p{P_FULL}anti_traj": flight["wall_ms"],
        "constrained_flight_p50": statistics.median(cflight["runs"]["prox"]["wall"][1:]),
        "hexa_traj": hexa["traj"][0], "hexa_pos": hexa["pos"][0]},
        "closed_loop": {tag: {k: v for k, v in run.items() if k != "launches"}
                        for tag, run in loops.items()},
        "launch_tier": {k: v for k, v in tier.items() if k != "fcu_tail"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's solve routes through ``mpc_fn`` on the card and
checks them: the linesearch APG on the hand-written whole-solve kernel
(flown by ``RecedingHorizonController`` on both iris flight configs and
both hexa ones), MPPI and fixed-step APG on the hand-written cost-oracle
kernels, and the policy family (the pure policy on the oracle, the
``refine_iters`` hybrid on the whole solve); then flies the closed loop
(the engine node on the card against the simulated FCU over UDP) and the
two-process launch tier, serves batched solves and fleets of every
family on the kernels' scenario axis, runs the learning loop (a logged
flight, the SDE fitted to it, its metric probed, a policy distilled from
batched whole-solve labels and flown), and tunes MPPI knobs and tracking
weights on that axis, then flies the mismatch sweep and the geometric
launch node, and last brings up the SITL deployment stack (the MAVLink
router, the mission layer, the engine node on the card behind the router,
the launch tier's router node and mission REPL, and the preflight), and the
reduced matmul precision (the bf16 trunk of the JAX package's
``matmul_precision: default``, its default above 128 particles), and the
mesh layer (rank pairs on the card over ``torch.distributed``).
Phases
(each prints a line; any failure raises and the script exits non-zero
without a result):

1. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds the three kernel libraries from ``sde4mbrl_px4_tpu_torch/csrc``
   (``apg_solve``, its bf16 particle forms ``apg_solve_bf16`` and
   ``cost_oracle``; one ``nvcc`` each, in parallel) and prints the build
   seconds and the compiler's register/spill/shared-memory summary per
   ``<PART, SC>`` form;
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
    ``CTRL_TRAJ_ACTIVE`` with the FCU still on, both exiting 0 on SIGTERM;
20. batched scenario solves and the fleet (``parallel/batched.py``,
    ``parallel/fleet.py``): the whole-solve kernel on its scenario axis, a
    grid of B blocks (P=1) or B clusters (particles) in one launch. Held
    bit for bit to each scenario's solo kernel solve: B = 1 on a traj
    flagship tick, every scenario of iris posctrl at ``bench.py``'s cell
    (B = 256, 50 iterations, ``make_batch_inputs(spread=0.5)``, its
    rotating 0.5 m targets), of hexa posctrl at B = 64, and of the fixed
    5-iteration P=512 antithetic solve at B = 4 with its batched
    ``trajectory`` launch (``x_evol``); two of the B = 256 scenarios and
    one P=512 scenario against the plain version (rtol 2e-4 / atol 2e-5,
    the particle tolerances; equal steps); the batched ``trajectory``
    against the plain rollouts (rtol 1e-5); the batched steps timed at
    B = 1, 132, 256 and 1024 (host p50 per step, device ms, iterations per
    solve, solves/s); then ``sim/fleet_serving.py --vehicles 64 --seconds
    8`` (gate: ``RESULT: PASS``, the cold tick's age 0 and a steady age
    above 0; its busy time p50/p99 printed beside a tick's device time);
21. the policy family (``solver: policy``, ``models/policy.py``) on the
    four shipped checkpoints (``configs/models/*_policy.pkl``, loaded
    through ``policy.params_path``): the pure policy, 4 chained solves on
    the card against the plain version on the CPU from the same states
    (|du| <= 1e-5, telemetry cost rtol 2e-5, ``x_evol`` against the mean
    rollout of the card's plan rtol 1e-5; one ``value_batch`` and one
    ``trajectory`` launch per solve); the ``refine_iters`` hybrid on iris
    traj at 3 and 15, a cold and 5 warm solves, each kernel against the
    plain whole solve from the same warm start (rtol 2e-4 / atol 2e-5,
    equal steps; one ``apg_solve`` launch per solve), ``iter_budget`` 2
    giving 2 steps; 50 chained ticks of the pure policy and of the hybrid
    at 3 and 15 timed (p50 from ``mpc_fn`` dispatch to the plan on the
    host, and the device span); the closed loop with ``--solver policy``,
    6 s at time-scale 1: ``--refine-iters 15`` gated at its PASS (0.35 m,
    ``MPC_ON``), ``--refine-iters 0`` printed;
22. the batched oracle routes: one ``value_batch`` launch over B x K plans
    (B = 1, 4, 64, 256 x K = 1, 8, 64 at P=1; P=512 antithetic at B = 4, K
    = 1, 4; the padded trunk and the proximal form at B = 4) and one
    ``value_and_grad`` launch over B plans (B = 1, 64, 256; P=512 and
    proximal at B = 4), every scenario bit-equal to its solo launch and
    the first and last within the oracle tolerances of the plain oracle
    (2e-5; gradients 5e-4 / 5e-5), each launch timed; the batched solves,
    each scenario against its solo ``mpc_fn`` on the card from the same
    inputs and draws: MPPI at B = 64 (K = 64, 8 rounds; bit for bit),
    fixed-step APG at B = 64 (posctrl without its linesearch block) and at
    P=512 antithetic, B = 4 (bit for bit but ``grad_sqr``, held to 1e-6
    relative), the policy at B = 256, pure and at ``refine_iters`` 15 (the
    network's plans to 1e-6; the kernels given the batch's plans bit for
    bit; a warm hybrid step bit for bit), their steps timed (ms and
    solves/s); the fleet demo with ``--solver policy --refine-iters 15`` and
    ``--solver mppi``, 64 vehicles, 4 s (gate: PASS at 0.35 m; busy p50/p99
    and device ms per tick printed);
23. the particle options (``cost_params.risk_lambda``, ``initial_state_std``)
    on the particle forms of kernels #1-#3, kernel against plain on the same
    draws, on ``p512anti`` (one chunk a block), P=1024 antithetic (two
    chunks a block), the altitude floor's ``<true, penalty>`` at P=128 and
    the proximal form at P=64 in chunks of 16: with risk (lambda 2), the
    example's state-noise starts, and both; the whole solve at a fixed 5
    iterations (equal steps, the particle tolerances), ``value_batch`` K = 1,
    4 and ``value_and_grad`` (values 5e-4, gradients 5e-4 / 5e-5); each
    case's risk-and-starts solve and oracle on their cluster against C = 1
    bit for bit; the new branches timed (the P=512 solve without and with
    each option, P=1024 without and with risk, the oracle per launch) and
    the P=1 ``value_batch`` on the shared-memory step (the trunk padded to
    72 units) timed beside its bound;
24. the particle options through the entry points: MPPI over K = 64 x
    P = 128 antithetic paths (4 chained solves, kernels against the plain
    oracle on the same draws, |du| <= 1e-4; one particle ``value_batch`` a
    round), the fixed-step route with risk and starts at P=512, the batched
    route (B = 4 with risk and starts, each scenario bit-equal to its solo
    ``mpc_fn``; the batched oracle bit-equal to its solo launches),
    ``sim/uncertainty.py`` at P=1024 (every variant's ms per solve), a short
    ``sim/noise_robustness.py`` (4 s x 1 seed; gate: finite readings) and
    the single-solve floor back-off (gate: the risk-averse and particle
    plans' terminal z at least 0.01 m above the mean plan's).

25. the learning loop: (a) the iris closed loop, 6 s at time-scale 1, with
    ``--log`` to ``.npz`` and to ``.ulg`` (gate: its PASS; both files read
    back and agree); (b) ``sim/train_model.py`` at the example's size (gate:
    its ``e_train < 0.8 e_prior``), then ``LEARN_SDE_STEPS`` ``train_sde``
    steps on the log of (a) from the shipped checkpoint with its motor gains
    moved by +5 % (gate: the loss on a fixed batch falls); steps/s of both; (c) the ``hover_diag`` probe of
    ``iris_traj_mpc.yaml`` on the card against its committed file (rtol
    1e-4), then the checkpoint of (b), probed at build (its file written to
    a temporary cache), flying ``LEARN_TICKS`` chained traj solves (one
    ``apg_solve`` launch each) and its fixed 10-iteration solve held to the
    plain whole solve; (d) ``sim/policy_distill.py`` at the example's widths
    (4096 states, 300-iteration labels, one DAgger round of 32 x 100, hidden
    256 256, 3000 steps; gate: its ``RESULT: PASS``): each label call one
    ``apg_solve`` launch (``ceil(n / B)`` at B = n), its first 8
    scenarios bit-equal to their solo ``mpc_fn`` solves, the shoot-out's
    launches (APG one ``apg_solve`` a tick, the distilled policy one
    ``value_batch`` and one ``trajectory``), the distilled policy against
    its plain version (phase 21's check), and one label launch per config
    re-run for its device time and labels/s; (e) a 32-wide trunk refused
    when ``make_mpc_from_config`` builds the solver (fault 7), with no
    launch.
26. batched tuning (``tuning/tuner.py``) on both iris configs:
    ``tune_mppi`` at ``tools/tune_mppi.py``'s default grid (27 candidates,
    K = 64, 8 rounds) and ``tune_cost_weights`` on a 27-row grid (noisy
    plant, ``effort_weight`` 0.05), 40 periods each: every period one
    batched solve over the 27 candidates (MPPI: 10 ``value_batch`` launches
    over 27 x 64 plans and one ``trajectory``; weights: one ``apg_solve``
    launch of 27 blocks, each candidate's weights in its consts row); the
    ranked table, ms a period, closed-loop solves/s and launches a period;
    candidates 0, 9, 13 and 26 at periods 0 and 20 bit-equal to their solo
    ``mpc_fn`` built with their own knobs or weights; one MPPI period of
    all 27 against the plain oracle on the same draws (scores rtol 1e-5,
    plans |du| <= 1e-4) and the four candidates' weight solves at 10
    iterations against the plain whole solve (rtol 2e-4 / atol 2e-5, equal
    steps); the kernels timed at the sweeps' shapes; then the iris mismatch
    sweep in full (``sim/mismatch_sweep.py``, its JSON to a temporary
    directory; gate: its PASS with the native geometric controller flown,
    one ``apg_solve`` a period), the geometric launch node against
    ``fcu_sim`` for 2 s (the node first, so it flies the plant from its
    first state; gates: commands sent, the FCU at ``MPC_ON``, both exit 0
    on SIGTERM), and
    ``sim/geometric_baseline.py`` for 6 s (gate: its PASS, the circle
    tracked within 0.6 m).
27. the SITL deployment stack: (a) the router test topology (an FCU server
    endpoint, an unfiltered sink, an MPC sink with ``AllowMsgIdOut 367`` /
    ``AllowMsgIdIn 368``, free ports) on the Python twin and the native
    core (``csrc/router.cpp``, built in phase 2: its absence fails the
    phase): a paced burst reaches the right sinks, no filtered id leaks,
    the MPC side's 368 replies reach the FCU; then ``sim/bench_router.py``
    at its default (frames/s of each and their ratio); (b)
    ``sim/full_sitl_stack.py --seconds 8`` as a subprocess, the engine node
    on the card, while a socket at the conf's liveview address
    (127.0.0.1:14996) feeds the port's ``LiveMonitor`` (gates: ``RESULT:
    PASS``, the native router, the engine in the traj or pos mode with
    iterations, both message ids on the tap, the engine process's launches
    the whole solve's only; printed: the station keeping, the engine's
    solve ms, the router's per-endpoint counts, the tap's rates); (c) the
    router launch node on ``router_sitl.yaml`` rewritten to free ports
    (READY, a frame forwarded, rc 0 on SIGTERM) and ``iris_sdectrl.yaml
    --repl`` with a script on stdin (READY, the mission's load line, no
    ``error:``, rc 0); (d) ``sim/preflight.py --solve`` in this process
    (rc 0, the card on its device line, one ``apg_solve`` launch).
28. reduced matmul precision, the bf16 trunk (``MPCPieces.trunk_bf16``,
    on the routes the JAX package sends to XLA): (a) each bf16 form
    against its plain bf16 twin on the card's tensors and against its own
    fp32 form, same inputs and draws (the whole solve's particle form at a
    fixed 5 iterations, P=512 antithetic; ``value_and_grad`` and
    ``value_batch`` K = 1, 4 at P=512; ``value_batch`` at K=64 x P=256 and
    at P=1, K=256 on the register chain and K=64 on the shared-memory
    step; the options forms, with risk and starts, at P=512 and at P=1024,
    two chunks a block: the whole solve, ``value_and_grad`` and
    ``value_batch`` K = 1, 4), each within ``BF16_TOL`` of its twin and
    more than 10x that from its fp32 form, timed beside its fp32 form and
    (but the options forms) its bound (fp32 CUDA cores, and bf16 tensor
    cores); (b) the flagship, iris traj at
    P=512 antithetic without the key, 20 chained solves through
    ``load_mpc_from_cfgfile`` -> ``mpc_fn``, one bf16 ``apg_solve`` and one
    fp32 ``trajectory`` launch each, beside the same config at
    ``matmul_precision: highest`` (wall and device p50, iterations,
    tracking gate 0.5 m); (c) the fixed-step route at P=512,
    ``sim/uncertainty.py`` at P=1024, MPPI at P=1 and K=256 with the key
    (kernels against the plain bf16 oracle, |du| <= 1e-4) and the pure
    policy with the key (its cost against the plain bf16 oracle, and more
    than 10x that tolerance from the same states' cost at ``highest``),
    each with its bf16 launches; (d) the route table: per config, the trunk's
    precision on the card and the forms it launches. Phases 11-13, 18, 20,
    22 and 24 fly P=512 or P=1024 without the key: their solves run the
    bf16 forms now, as the JAX package's do on its TPU.
29. the mesh layer (``parallel/mesh.py``, ``parallel/distributed.py``):
    one pair of fresh rank processes, a gloo world of two sharing the
    card, runs ``parallel/rank_tasks.py::suite`` against this process's
    one-process references: (a) iris posctrl at B = 256 over dp = 2, each
    scenario's plans bit-equal to the one-process batched solve (each
    rank's device ms per step, the gather ms); (b) the P=512 antithetic
    flagship at a fixed 5 iterations over mc = 2, within rtol 2e-4 / atol
    2e-5 of the one-process host loop and of the whole-solve kernel (ms an
    iteration, the collectives' share); (c) a 64-vehicle fleet over 4
    ticks, its states equal to one process's; (d) ``label_states`` and
    ``tune_cost_weights`` over dp = 2, each row equal; (e) two
    ``launch.py --coordinator`` engine nodes, READY and a clean SIGTERM.
    Each route's launches are counted on each rank (zeroed just before it)
    and added to the kernels line as ``mesh_launches``.

In phases 6-8, 11-13, 15-18, 20-22, 24-26, 27 (d), 28 and 29 every kernel's launch count is set to 0 just
before the route runs and read just after: each route must have launched
exactly the kernels it is made of, as many times as its solves need (a
particle solve is one ``apg_solve`` and one ``trajectory`` launch), and
JAX must never be imported.

The lines before the last are the routes' JSON record (``{"record": ...}``:
per-solve times, the closed loops, the launch tier, the fleets, the policy
family, the batched routes, the tuning sweeps, the mismatch sweep, the
geometric node and the SITL stack), the kernels' JSON line and the card's name and
power limit; the last line is
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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
TOLS = {"iris_traj_mpc": (10, 2e-4, 2e-5), "iris_posctrl_mpc": (8, 5e-4, 5e-5)}
# fixed-step APG: a stepsize that accepts steps on the problem of each config
FIXED_STEP = {"iris_traj_mpc": 1e-3, "iris_posctrl_mpc": 1e-5}
LIBS = ("apg_solve", "apg_solve_bf16", "cost_oracle")
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
# the batched solves (phase 20): bench.py's cell (:787-855), B = 256 at a
# 50-iteration budget; timed at one block, one wave of the 132 SMs, B = 256
# and eight waves; the hexa and particle batches held to their solo solves
BATCH_ITERS, BATCH_B, BATCH_STEPS = 50, 256, 6
BATCH_SIZES = (1, 132, BATCH_B, 1024)
HEXA_B, PART_B = 64, 4
FLEET_ARGV = ["--vehicles", "64", "--seconds", "8"]   # examples/fleet_serving.py
LAUNCH_READY_S, LAUNCH_ON_S = 300.0, 30.0   # the launch tier's time limits
# the policy family (phase 21): the shipped checkpoints, the hybrid's polish
# iterations, the chained replay and the timed ticks
POLICY_CKPTS = (("iris", "traj"), ("iris", "posctrl"), ("hexa", "traj"), ("hexa", "posctrl"))
POLICY_REFINE = (3, 15)
POLICY_REPLAY, POLICY_TICKS = 4, 50
# the batched oracle routes (phase 22): value_batch over B x K plans,
# value_and_grad over B plans; the batched MPPI and fixed-step solves, the
# policy's; the fleet demo of the other families
ORACLE_B, ORACLE_K, VG_B = (1, 4, 64, 256), (1, 8, 64), (1, 64, 256)
SOLVE_B, POLICY_B = 64, 256
FLEET_FAMILY_ARGV = ["--vehicles", "64", "--seconds", "4"]
# the least time of a call: the H100 SXM's fp32 rate outside the tensor cores
# and its HBM3 rate (NVIDIA's published H100 SXM figures)
PEAK_FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12
# ... and its dense bf16 tensor-core rate: the bound of the bf16 trunk once
# its products run on tensor cores (ROADMAP.md §2 item 32)
PEAK_BF16_TC_FLOPS = 989e12


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


def bf16_counts() -> dict:
    """The launches of the bf16 forms (the trunk on bf16 operands), counted
    apart by each wrapper beside its total."""
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    return {"apg_solve": AK.apg_solve_kernel.launches_bf16,
            "value_batch": CO.value_batch_kernel.launches_bf16,
            "value_and_grad": CO.value_and_grad_kernel.launches_bf16}


def zero_counts() -> None:
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    for fn in (AK.apg_solve_kernel, CO.value_batch_kernel,
               CO.value_and_grad_kernel, CO.trajectory_kernel):
        fn.launches = 0
    for fn in (AK.apg_solve_kernel, CO.value_batch_kernel, CO.value_and_grad_kernel):
        fn.launches_bf16 = 0


def check_route(name: str, expected: dict, bf16: dict = None) -> dict:
    """The launch counts of a route just run against what it needs; with
    ``bf16`` its bf16 forms' launches too (printed either way)."""
    got, half = counts(), bf16_counts()
    log(f"kernel launches in the {name} route: {got} (expected {expected}); of them bf16 "
        f"{half}" + (f" (expected {bf16})" if bf16 is not None else ""))
    if got != expected or not any(got.values()) or (bf16 is not None and half != bf16):
        raise AssertionError(f"the {name} route did not launch the kernels it needs")
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    return got


def form_name(kernel: str, args: list) -> str:
    """An instantiation as the build log's mangled name gives it: ``kernel<PART,
    SC>`` plus its flags (the whole solve's clock stamps, the P=1
    ``value_batch``'s register chain or shared-memory step, the particle
    forms' options, the bf16 trunk: ``apg_solve<PART, SC, PROF, OPT, BF>``,
    ``value_batch<PART, SC, REG, OPT, BF>``, ``value_and_grad<PART, SC,
    OPT, BF>``); ``trajectory``'s one flag."""
    if kernel == "trajectory_kernel":
        return f"{kernel}<{'register chain' if args[0] else 'shared-memory step'}>"
    if len(args) < 2:
        return kernel
    flags = args[2:]
    extra = ""
    if kernel == "apg_solve_kernel":
        extra = ", clock-stamped" if flags[:1] == [1] else ""
        opt, bf16 = flags[1:2] == [1], flags[2:3] == [1]
    elif kernel == "value_batch_kernel":
        if flags and not args[0]:
            extra = ", register chain" if flags[0] else ", shared-memory step"
        opt, bf16 = flags[1:2] == [1], flags[2:3] == [1]
    else:
        opt, bf16 = flags[:1] == [1], flags[1:2] == [1]
    extra += ", bf16" if bf16 else ""
    extra += ", options" if opt else ""
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
    AK.load_apg_library(bf16=True)
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
    # (the P=1 value_batch's three bf16 forms on each: 14 and 7)
    if len(p1) != 14 or any(p1.values()):
        raise AssertionError(f"a P=1 form on the register chain spills: {p1}")
    # ten particle forms, nine more with the particle options, and the
    # eighteen of both with the bf16 trunk
    if len(part) != 37 or len(wide) != 7:
        raise AssertionError(f"the build log lacks a form: {part}, {wide}")
    vb = {k: v for k, v in part.items() if k.startswith("value_batch_kernel<true")}
    if any(v[1] for v in vb.values()):
        raise AssertionError(f"a cluster form of value_batch spills: {vb}")
    # the particle forms without the options compile to the code they had
    # before them, spill-free, and so do the oracle's options forms; the
    # whole solve's options forms are printed
    held = {k: v for k, v in part.items()
            if "options" not in k or not k.startswith("apg_solve_kernel")}
    if any(v[1] for v in held.values()):
        raise AssertionError(f"a particle form spills: {held}")
    log(f"  the whole solve's particle-options forms, (registers, spill stores in bytes): "
        f"{ {k: v for k, v in part.items() if k not in held} }")


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
    ``kw`` goes to the kernel's wrapper (``cluster``, ``chunk``, ``starts``)
    and, but ``cluster``, to the plain version; ``n_plain=0`` times the
    kernel only."""
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
        AK.apg_solve_plain(*args, precond=pre,
                           **{k: v for k, v in kw.items() if k != "cluster"})[0].yk.cpu()
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
    through ``fn``, which has that wrapper's solo signature (measurement and
    parity only). The loader calls the ``_batched`` wrappers; a solo solve
    is their B = 1, which ``fn`` serves on the scenario's inputs."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader
    from sde4mbrl_px4_tpu_torch.solver.apg import APGState, CostOracle

    one = lambda t: None if t is None else t[0]

    def solve(model, params, cp, apg, ts, x0, x_ref, u_prev, noise, P, lb, ub, u_init,
              t_init=None, starts=None, **kw):
        assert x0.shape[0] == 1, "routed serves solo solves (B = 1)"
        if starts is not None:                # (the clock-stamped twin takes none)
            kw["starts"] = starts[0]
        st, x_evol = fn(model, params, cp, apg, ts, x0[0], x_ref[0], u_prev[0], one(noise),
                        P, lb, ub, u_init[0], one(t_init), **kw)
        return APGState(*(f[None] for f in st)), x_evol[None]

    def oracle(model, params, cp, ts, x0, x_ref, u_prev, noise, P, maxls, starts=None, **kw):
        assert x0.shape[0] == 1, "routed serves solo solves (B = 1)"
        o = fn(model, params, cp, ts, x0[0], x_ref[0], u_prev[0], one(noise), P, maxls,
               starts=one(starts), **kw)
        return CostOracle(
            value=lambda u: o.value(u[0])[None],
            value_batch=lambda U: o.value_batch(U[0])[None],
            value_and_grad=lambda u: tuple(v[None] for v in o.value_and_grad(u[0])),
            trajectory=lambda u: o.trajectory(u[0])[None])

    attr = name + "_batched"
    orig = getattr(mpc_loader, attr)
    setattr(mpc_loader, attr, solve if name == "apg_solve_kernel" else oracle)
    try:
        yield
    finally:
        setattr(mpc_loader, attr, orig)


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
                          what: str = "particle solve", fp32_spread: bool = False,
                          starts=None) -> tuple:
    """A particle (or state-constrained) solve through the kernel and the
    plain version: equal steps, ``yk`` and ``opt_cost`` at the particle
    tolerances, ``x_evol`` (the ``trajectory`` launch, or the P=1 exit
    sweep's) the mean rollout of the control columns of the kernel's plan
    at rtol 1e-5 / atol 1e-6. With ``fp32_spread`` ``x_evol`` is held to
    the float64 rollout instead, each element within rtol 1e-5 / atol 1e-6
    plus twice the float32 spread of the plain rollout there
    (``rollout_spread``: a plan whose float32 rollout moves past 1e-5 with
    the summation order). ``starts``: the particles' (P, 13) initial states
    (``x_evol`` stays the rollout from x0). Returns (max |du|, max |dx| of
    ``x_evol``, steps)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    st_k, xe_k = AK.apg_solve_kernel(*args, precond=b.precond, chunk=chunk, starts=starts)
    torch.cuda.synchronize()
    st_p, _ = AK.apg_solve_plain(*args, precond=b.precond, chunk=chunk, starts=starts)
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


def cluster_vs_one(AK, args, chunk: int, pre, tag: str, starts=None) -> dict:
    """A particle solve at its chosen cluster and at C = 1 (one block
    sweeping every chunk): equal steps, max|du| and the relative
    ``opt_cost`` gap within 1e-6 (equal bits expected: the blocks sum the
    chunks' partials in chunk order; with the cost's ``risk_lambda`` both
    moments of the totals too). Returns the plan of the chosen cluster and
    both results."""
    import ctypes

    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts

    st_c, _ = AK.apg_solve_kernel(*args, precond=pre, chunk=chunk, starts=starts)
    st_1, _ = AK.apg_solve_kernel(*args, precond=pre, chunk=chunk, cluster=1, starts=starts)
    torch.cuda.synchronize()
    model, params, cp, apg, ts, x0, x_ref, u_prev, _, P, lb, ub, _ = args
    _, a = build_consts(model, params, cp, apg, ts, x0, x_ref, u_prev, lb, ub,
                        has_pre=pre is not None, particles=True)
    a.has_starts = int(starts is not None)
    AK.plan_solve_particles(a, P, chunk)
    lib = AK.load_apg_library()
    n = ctypes.c_int(0)
    rc = lib.apg_max_active_clusters(ctypes.byref(a), ctypes.byref(n))
    out = {"cluster": a.cluster, "chunks_per_block": a.chunks_per_block, "Pc": a.Pc,
           "n_chunks": a.n_chunks,
           "c_max": lib.apg_cluster_max(a.sc_kind, 0, int(bool(a.risk or a.has_starts))),
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


def particle_oracle_parity(kern, plain, U, tag: str, what: str = "particle oracle",
                           vtol: float = 2e-5) -> dict:
    """The particle (or state-constrained) oracle kernels against the plain
    oracle on the same draws: ``value`` (``value_batch`` at K=1) and
    ``value_batch`` at K=len(U) at rtol ``vtol`` (2e-5; the particle
    options' checks take the particle tolerance 5e-4), ``value_and_grad``
    (value rtol ``vtol``, gradient rtol 5e-4 / atol 5e-5). Returns max |err|
    per kernel."""
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
        f"{rel:.3e} (rtol {vtol:g}); value_and_grad value rel {dv:.3e}, grad max|d| {dg:.3e} "
        f"(rtol 5e-4, atol 5e-5)")
    if not (rel <= vtol and dv <= vtol and bool(torch.isfinite(vk).all())
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
        out[name] = {"c_max": lib.oracle_cluster_max(kind, o.sc_kind, 0, o.bf16),
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


def work(b, kind: str, P: int = 1, K: int = 1, iters: float = 0, B: int = 1) -> float:
    """FLOPs of one call, from its shapes: ``value_batch`` K x P rows
    forward over H steps; ``value_and_grad`` P rows forward and reverse
    (one trunk pass each way: that the particle forms re-run the trunk in
    the reverse is the kernels' choice, not work the function needs);
    ``trajectory`` one row forward; ``apg_solve`` iters + 2 gradients and
    iters K-candidate rollouts. A call over B scenarios (the scenario axis
    of ``apg_solve`` and ``trajectory``) does B times the work, ``iters``
    then the scenarios' mean iterations."""
    H, f = int(b.time_steps.shape[0]), trunk_flops(b)
    vg = P * H * 2 * f
    cands = K * P * H * f
    return B * {"value_batch": cands, "value_and_grad": vg, "trajectory": H * f,
                "apg_solve": (iters + 2) * vg + iters * cands}[kind]


def io_bytes(b, kind: str, P: int = 1, K: int = 1, n_consts: int = 0, B: int = 1,
             starts: bool = False) -> int:
    """Bytes one call must move: the consts buffer, the plans (nZ wide), the
    (H, P, 13) Brownian block and (``starts``) the (P, 13) particles' starts
    read once, the outputs written once; over B scenarios each has its own,
    but the preconditioner is shared."""
    H, nZ = int(b.time_steps.shape[0]), int(b.lb_z.shape[0])
    noise = (H * P * 13 + (P * 13 if starts else 0)) if P > 1 else 0
    pre = H * nZ if b.precond is not None and kind == "apg_solve" else 0
    io = {"value_batch": K * H * nZ + K, "value_and_grad": 2 * H * nZ + 1,
          "trajectory": H * nZ + (H + 1) * 13,
          "apg_solve": 2 * H * nZ + 1 + 8 + (H + 1) * 13}[kind]
    return 4 * (B * (n_consts + noise + io) + pre)


def bound(b, kind: str, n_consts: int, tc: bool = False, **shape) -> tuple:
    """(bound_ms, bound_by): the larger of the call's FLOPs over the fp32
    peak (``tc``: the bf16 tensor-core peak) and its bytes over the HBM
    rate."""
    t_ops = work(b, kind, **{k: v for k, v in shape.items() if k in ("P", "K", "iters", "B")})
    t_ops = t_ops / (PEAK_BF16_TC_FLOPS if tc else PEAK_FP32_FLOPS) * 1e3
    t_bytes = io_bytes(b, kind, n_consts=n_consts, **{k: v for k, v in shape.items()
                                                      if k in ("P", "K", "B", "starts")}
                       ) / HBM_BYTES_S * 1e3
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


def bench_targets(xs) -> list:
    """``bench.py``'s rotating targets (:815-823): the states offset by 0.5 m
    along x, y and -z in turn, so that every step every scenario replans."""
    import torch

    offs = torch.zeros((3, 13), device=xs.device)
    offs[0, 0], offs[1, 1], offs[2, 2] = 0.5, 0.5, -0.5
    return [xs + o for o in offs]


def scenario_state(st, i: int):
    """Scenario i's warm start of a batched ``APGState``."""
    return type(st)(*(f[i] for f in st))


def bit_equal_to_solo(tag: str, sol, solos: list, skip: tuple = ()) -> int:
    """Every scenario of a batched solve against its solo solve (``mpc_fn``
    on the card): ``u_opt``, ``x_evol`` and every ``opt_state`` field but
    those in ``skip`` bit for bit."""
    import torch

    fields = [k for k in sol.opt_state._fields if k not in skip]
    bad = [i for i, one in enumerate(solos)
           if not (torch.equal(one.u_opt, sol.u_opt[i]) and torch.equal(one.x_evol, sol.x_evol[i])
                   and all(torch.equal(getattr(one.opt_state, f), getattr(sol.opt_state, f)[i])
                           for f in fields))]
    steps = sol.opt_state.num_steps
    log(f"batched {tag}: {len(solos)} scenario(s) against their solo kernel solves: "
        f"{len(solos) - len(bad)} bit-equal (u_opt, x_evol, opt_state); iterations "
        f"{float(steps.min()):.0f}-{float(steps.max()):.0f}, mean {float(steps.mean()):.2f}")
    if bad:
        raise AssertionError(f"batched {tag}: scenarios {bad[:10]} differ from their solo solves")
    return len(solos)


def batched_pair(cfg: dict, dev) -> tuple:
    """One config's solo and batched entry points on the card:
    ``(reset_fn, mpc_fn, batched_reset, batched_mpc, state_from_traj, bundle)``."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    _, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    reset_b, mpc_b, _ = make_batched_mpc(copy.deepcopy(cfg), device=dev)
    return reset_fn, mpc_fn, reset_b, mpc_b, sft, b


def timed_batched_steps(mpc_b, reset_b, B: int, dev, n: int = BATCH_STEPS) -> dict:
    """``bench.py``'s batched cell (:787-855) at B scenarios: states from
    ``make_batch_inputs(spread=0.5)``, one warm step, then ``n`` re-targeted
    steps, the launch counts zeroed just before them and read just after.
    Per step: host wall p50 (dispatch to a synchronised result), device ms
    p50 (CUDA events), iterations per solve (mean, and the slowest scenario,
    which sets its wave's length); the last step's inputs and solution."""
    import torch

    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs

    xs, _ = make_batch_inputs(B, spread=0.5, device=dev)
    tg, ts = bench_targets(xs), torch.zeros(B, device=dev)
    sol = mpc_b(xs, None, reset_b(xs, None, xs), ts, tg[0])
    torch.cuda.synchronize()
    wall, dev_ms, steps, slowest = [], [], [], []
    zero_counts()
    for k in range(n):
        st_in, tgt = sol.opt_state, tg[(k + 1) % 3]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        sol = mpc_b(xs, None, st_in, ts, tgt)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        steps.append(float(sol.opt_state.num_steps.mean()))
        slowest.append(float(sol.opt_state.num_steps.max()))
    got = check_route(f"batched B={B}", {"apg_solve": n, "value_batch": 0,
                                         "value_and_grad": 0, "trajectory": 0})
    if not (bool(torch.isfinite(sol.u_opt).all()) and bool(torch.isfinite(sol.x_evol).all())):
        raise AssertionError(f"batched B={B} returned non-finite values")
    p50 = statistics.median(wall)
    return {"B": B, "wall_ms_p50": p50, "device_ms_p50": statistics.median(dev_ms),
            "steps_per_solve": statistics.mean(steps), "slowest_steps": statistics.mean(slowest),
            "solves_per_s": B / p50 * 1e3, "launches": got, "last": (xs, st_in, ts, tgt, sol)}


def phase_batched(dev, card: str) -> dict:
    """The batched scenario solves (``parallel/batched.py``): the whole-solve
    kernel over a grid of B scenarios, each held to its solo kernel solve
    bit for bit (the B = 1 launch on a traj flagship tick; iris posctrl at
    ``bench.py``'s 50 iterations and B = 256; hexa posctrl at B = 64; the
    fixed 5-iteration P=512 antithetic solve at B = 4, with its batched
    ``trajectory`` launch), two of the B = 256 scenarios and one of the
    P=512 ones held to the plain version (rtol 2e-4 / atol 2e-5, and the
    particle tolerances; equal steps), the batched steps timed at B in
    ``BATCH_SIZES``, and the batched ``trajectory`` launch against the
    plain rollouts."""
    import ctypes

    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import batch_consts, build_consts
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs

    out = {"bit_equal": {}}
    # B = 1 is the solo launch: a traj flagship tick (200 iterations at most)
    reset_fn, mpc_fn, reset_b, mpc_b, sft, _ = batched_pair(config("iris_traj_mpc"), dev)
    t = np.float32(3.0)
    x = enu2ned(sft(t))
    x[0] += 0.2
    one = mpc_fn(x, None, reset_fn(x, None, x), t, x)
    sol = mpc_b(x[None], None, reset_b(x[None], None, x[None]),
                torch.full((1,), float(t), device=dev), x[None])
    out["bit_equal"]["B=1 traj"] = bit_equal_to_solo("B = 1, a traj flagship tick", sol, [one])

    # iris posctrl at 50 iterations: the timed steps, then B = 256 held to
    # its solo solves and two scenarios to the plain version
    cfg = config("iris_posctrl_mpc", max_iter=BATCH_ITERS)
    reset_fn, mpc_fn, reset_b, mpc_b, _, b = batched_pair(cfg, dev)
    runs = {}
    for B in BATCH_SIZES:
        r = timed_batched_steps(mpc_b, reset_b, B, dev)
        runs[B] = r
        log(f"batched iris posctrl, {BATCH_ITERS}-iteration budget, B={B} ({card}): "
            f"{r['wall_ms_p50']:.3f} ms per step p50 (device {r['device_ms_p50']:.3f} ms), "
            f"{r['steps_per_solve']:.2f} iterations per solve (slowest scenario "
            f"{r['slowest_steps']:.1f}), {r['solves_per_s']:.0f} solves/s")
    xs, st_in, ts, tgt, sol = runs[BATCH_B]["last"]
    out["bit_equal"][f"iris B={BATCH_B}"] = bit_equal_to_solo(
        f"iris posctrl B={BATCH_B}", sol,
        [mpc_fn(xs[i], None, scenario_state(st_in, i), 0.0, tgt[i]) for i in range(BATCH_B)])
    _, _, pieces = build_mpc(copy.deepcopy(cfg), device=dev)
    x_ref = pieces.build_ref(ts, pieces.targets(tgt))
    idx = torch.tensor([0, BATCH_B - 1], device=dev)
    n_u = b.model.n_u
    w0 = time.perf_counter()
    st_p, _ = AK.apg_solve_plain_batched(
        b.model, b.params, b.cost_params, b.apg_config, b.time_steps, xs[idx], x_ref[idx],
        st_in.yk[idx, 0], None, 1, b.lb_z, b.ub_z, st_in.yk[idx],
        t_init=st_in.stepsize[idx], precond=b.precond)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - w0) * 1e3 / 2
    du = float((st_p.yk[:, :, :n_u] - sol.u_opt[idx]).abs().max())
    log(f"batched B={BATCH_B}, scenarios 0 and {BATCH_B - 1} against the plain version "
        f"({plain_ms:.1f} ms per scenario's plain solve): steps "
        f"{sol.opt_state.num_steps[idx].tolist()} / {st_p.num_steps.tolist()}, max|du| "
        f"{du:.3e} (rtol 2e-4 / atol 2e-5)")
    if not (torch.equal(st_p.num_steps, sol.opt_state.num_steps[idx]) and torch.allclose(
            sol.u_opt[idx], st_p.yk[:, :, :n_u], rtol=2e-4, atol=2e-5)):
        raise AssertionError("the batched solve does not match the plain version")
    out.update(runs={B: {k: v for k, v in r.items() if k != "last"} for B, r in runs.items()},
               plain_ms=plain_ms, du=du, bundle=b)

    # hexa posctrl at B = 64, the config's own 100-iteration budget
    reset_fn, mpc_fn, reset_b, mpc_b, _, _ = batched_pair(config("hexa_posctrl_mpc"), dev)
    xs, _ = make_batch_inputs(HEXA_B, spread=0.5, device=dev)
    tgt = bench_targets(xs)[0]
    st_in = reset_b(xs, None, xs)
    sol = mpc_b(xs, None, st_in, torch.zeros(HEXA_B, device=dev), tgt)
    out["bit_equal"][f"hexa B={HEXA_B}"] = bit_equal_to_solo(
        f"hexa posctrl B={HEXA_B}", sol,
        [mpc_fn(xs[i], None, scenario_state(st_in, i), 0.0, tgt[i]) for i in range(HEXA_B)])

    # P=512 antithetic, a fixed 5-iteration solve at B = 4 along the
    # lemniscate: one apg_solve launch over 4 clusters, one trajectory
    # launch over 4 blocks
    pcfg = config("iris_traj_mpc", particles=P_FULL, max_iter=5)
    reset_fn, mpc_fn, reset_b, mpc_b, sft, pb = batched_pair(pcfg, dev)
    ts = torch.tensor([3.0 + 0.5 * i for i in range(PART_B)], device=dev)
    xs = enu2ned(sft(ts))
    pp = build_mpc(copy.deepcopy(pcfg), device=dev)[2]
    x_refs = pp.build_ref(ts, xs)
    z = torch.stack([brownian(P_FULL, dev, antithetic=True, seed=i) for i in range(PART_B)])
    st_in = reset_b(xs, None, xs)
    torch.cuda.synchronize()
    zero_counts()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    sol = mpc_b(xs, iter([z]), st_in, ts, xs)
    e1.record()
    torch.cuda.synchronize()
    part_launches = check_route(f"batched P={P_FULL} B={PART_B}", {
        "apg_solve": 1, "value_batch": 0, "value_and_grad": 0, "trajectory": 1})
    part_ms = e0.elapsed_time(e1)
    out["bit_equal"][f"P={P_FULL} B={PART_B}"] = bit_equal_to_solo(
        f"P={P_FULL} antithetic B={PART_B} (x_evol from the batched trajectory)", sol,
        [mpc_fn(xs[i], iter([z[i]]), scenario_state(st_in, i), float(ts[i]), xs[i])
         for i in range(PART_B)])
    x_ref = x_refs[0]
    w0 = time.perf_counter()
    st_p, _ = AK.apg_solve_plain(
        pb.model, pb.params, pb.cost_params, pb.apg_config, pb.time_steps, xs[0], x_ref,
        st_in.yk[0, 0], z[0], P_FULL, pb.lb_z, pb.ub_z, st_in.yk[0],
        t_init=st_in.stepsize[0], precond=pb.precond, bf16=pp.trunk_bf16)
    torch.cuda.synchronize()
    part_plain_ms = (time.perf_counter() - w0) * 1e3
    part_du = float((st_p.yk[:, :n_u] - sol.u_opt[0]).abs().max())
    log(f"batched P={P_FULL} B={PART_B} ({part_ms:.3f} ms device for the batch), scenario 0 "
        f"against the plain version ({part_plain_ms:.1f} ms): steps "
        f"{int(sol.opt_state.num_steps[0])} / {int(st_p.num_steps)}, max|du| {part_du:.3e} "
        f"(rtol {PART_RTOL} / atol {PART_ATOL})")
    if not (int(st_p.num_steps) == int(sol.opt_state.num_steps[0]) and torch.allclose(
            sol.u_opt[0], st_p.yk[:, :n_u], rtol=PART_RTOL, atol=PART_ATOL)):
        raise AssertionError("the batched particle solve does not match the plain version")
    _, a = build_consts(pb.model, pb.params, pb.cost_params, pb.apg_config, pb.time_steps,
                        xs[0], x_ref, st_in.yk[0, 0], pb.lb_z, pb.ub_z,
                        has_pre=pb.precond is not None)
    AK.plan_solve_particles(a, P_FULL, 0)
    n_act = ctypes.c_int(0)
    rc = AK.load_apg_library().apg_max_active_clusters(ctypes.byref(a), ctypes.byref(n_act))
    out["cluster"] = {"cluster": a.cluster, "Pc": a.Pc, "clusters": PART_B,
                      "max_active_clusters": n_act.value if rc == 0 else f"error {rc}"}
    log(f"batched P={P_FULL}: {PART_B} clusters of C={a.cluster} blocks (Pc={a.Pc}); "
        f"cudaOccupancyMaxActiveClusters at that shape {out['cluster']['max_active_clusters']}")

    # the batched trajectory launch alone: the B = 4 plans, against the
    # plain rollout of each
    consts, o = build_consts(pb.model, pb.params, pb.cost_params, None, pb.time_steps, xs[0],
                             x_ref, st_in.yk[0, 0])
    consts = batch_consts(consts, o, xs, x_refs, st_in.yk[:, 0])
    plans = sol.opt_state.yk.contiguous()
    xe = CO.trajectory_kernel(consts, o, plans)
    plain = torch.stack([rollout_mean(pb.model, pb.params, xs[i], plans[i, :, :n_u],
                                      pb.time_steps) for i in range(PART_B)])
    traj_err = float((xe - plain).abs().max())
    if not torch.allclose(xe, plain, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"the batched trajectory does not match its plain version "
                             f"({traj_err:.3e})")
    traj_ms = per_launch_ms(lambda: CO.trajectory_kernel(consts, o, plans), 50)
    traj_plain_ms = per_launch_ms(lambda: rollout_mean(pb.model, pb.params, xs[0],
                                                       plans[0, :, :n_u], pb.time_steps), 5)
    log(f"batched trajectory, B={PART_B}: {traj_ms:.4f} ms per launch, against the plain "
        f"rollout of each plan max|dx| {traj_err:.3e} (rtol 1e-5 / atol 1e-6); one plan's "
        f"plain rollout {traj_plain_ms:.3f} ms")
    out.update(part={"launches": part_launches, "ms": part_ms, "plain_ms": part_plain_ms,
                     "du": part_du, "steps": sol.opt_state.num_steps.tolist(), "bundle": pb},
               traj={"ms": traj_ms, "plain_ms": traj_plain_ms, "err": traj_err},
               n_consts=o.n_consts)
    return out


def phase_fleet(card: str) -> dict:
    """The fleet demo, ``sim/fleet_serving.py --vehicles 64 --seconds 8`` on
    the card (one batched launch per 50 ms tick, plans pipelined): gates
    ``RESULT: PASS``, the cold tick's age 0 and a steady plan age above 0,
    and one ``apg_solve`` launch per tick; prints the tick's busy time
    p50/p99 beside the device time of a tick's solve."""
    import torch

    from sde4mbrl_px4_tpu_torch.sim import fleet_serving

    zero_counts()
    res = fleet_serving.run(FLEET_ARGV)
    torch.cuda.synchronize()
    res["launches"] = check_route("fleet", {"apg_solve": res["ticks"], "value_batch": 0,
                                            "value_and_grad": 0, "trajectory": 0})
    log(f"fleet demo ({card}; {res['vehicles']} vehicles, {res['ticks']} ticks): busy p50 "
        f"{res['busy_ms_p50']:.3f} ms, p99 {res['busy_ms_p99']:.3f} ms (budget "
        f"{res['budget_ms']:.0f} ms), a tick's solve on the device p50 "
        f"{res['device_ms_p50']:.3f} ms, plan age p50 {res['age_ms_p50']:.3f} ms (cold tick "
        f"{res['first_age']}), {res['vehicle_solves_per_s']:.0f} vehicle-solves/s; tracking "
        f"mean {res['err_mean']:.4f} m max {res['err_max']:.4f} m -> "
        f"{'PASS' if res['ok'] else 'FAIL'}")
    if not (res["ok"] and res["first_age"] == 0.0 and res["age_ms_p50"] > 0.0):
        raise AssertionError(f"the fleet demo failed: {res}")
    return res


def policy_config(vehicle: str, kind: str, refine: int = 0, **apg) -> dict:
    """A shipped config flown by its shipped policy checkpoint
    (``configs/models/<vehicle>_<kind>_policy.pkl``), ``refine_iters``
    ``refine``, the ``apg_mpc`` keys given."""
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(ROOT, f"configs/{vehicle}_{kind}_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg["policy"] = {"params_path": os.path.join(
        ROOT, f"configs/models/{vehicle}_{kind}_policy.pkl"), "refine_iters": refine}
    cfg["apg_mpc"].update(apg)
    return cfg


def policy_start(sft, dev):
    """(state, t0): the lemniscate at 3 s for a trajectory config, else the
    pinned offset state of the family replays."""
    import numpy as np

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    if sft is not None:
        return enu2ned(sft(np.float32(3.0))).to(dev), 3.0
    x = hover_state(dev)
    x[0], x[2] = 0.5, -0.3
    return x, 0.0


def policy_pure_parity(dev, vehicle: str, kind: str, n: int = POLICY_REPLAY) -> dict:
    """``n`` chained pure-policy solves on the card (the states of its own
    chain), each against the plain version on the CPU from the same state
    and warm start: the plan (|du| <= 1e-5: cuBLAS and the CPU's GEMM sum
    the 384-wide layers in other orders), the telemetry cost (rtol 2e-5),
    and ``x_evol`` against the mean rollout of the card's plan (rtol 1e-5).
    One ``value_batch`` and one ``trajectory`` launch per solve."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    cfg = policy_config(vehicle, kind)
    c, (reset_k, mpc_k), sft, b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    _, (reset_p, mpc_p), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    dt = float(c["_time_steps"][0])
    x, t0 = policy_start(sft, dev)
    st = reset_k(x, None, x)
    du = dc = dx = 0.0
    zero_counts()
    for k in range(n):
        t = t0 + k * dt
        sol = mpc_k(x, None, st, t, x)
        st_cpu = type(st)(*(f.cpu() for f in st))
        one = mpc_p(x.cpu(), None, st_cpu, t, x.cpu())
        du = max(du, float((sol.u_opt.cpu() - one.u_opt).abs().max()))
        dc = max(dc, abs(float(sol.opt_state.opt_cost) - float(one.opt_state.opt_cost))
                 / abs(float(one.opt_state.opt_cost)))
        ref = rollout_mean(b.model, b.params, x, sol.u_opt, b.time_steps)
        dx = max(dx, float((sol.x_evol - ref).abs().max()))
        if not (torch.allclose(sol.x_evol, ref, rtol=1e-5, atol=1e-6)
                and int(sol.opt_state.num_steps) == 0
                and bool(torch.equal(sol.opt_state.init_cost, sol.opt_state.opt_cost))):
            raise AssertionError(f"pure policy {vehicle} {kind}: x_evol or stats differ")
        st, x = sol.opt_state, sol.x_evol[1]
    got = check_route(f"pure policy {vehicle} {kind}", {
        "apg_solve": 0, "value_batch": n, "value_and_grad": 0, "trajectory": n})
    log(f"pure policy {vehicle} {kind} ({n} chained solves on the shipped checkpoint), card "
        f"against the plain CPU version: max|du| {du:.3e} (gate 1e-5), cost rel {dc:.3e} "
        f"(2e-5), x_evol against the rollout of the card's plan max|dx| {dx:.3e} (rtol 1e-5 / "
        f"atol 1e-6)")
    if not (du <= 1e-5 and dc <= 2e-5):
        raise AssertionError(f"the pure policy {vehicle} {kind} disagrees with plain")
    return {"du": du, "cost_rel": dc, "dx": dx, "launches": got}


def policy_hybrid_parity(dev, refine: int, warm: int = 5) -> dict:
    """The hybrid on iris traj at ``refine_iters``: a cold solve and ``warm``
    warm solves on the card, each against the plain whole solve on the card
    from the same warm start (rtol 2e-4 / atol 2e-5, equal ``num_steps``);
    one ``apg_solve`` launch per solve."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    c, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(
        policy_config("iris", "traj", refine), device=dev)
    dt = float(c["_time_steps"][0])
    x, t0 = policy_start(sft, dev)
    st = reset_fn(x, None, x)
    du, steps, plain_ms = 0.0, [], []
    for k in range(warm + 1):
        t = t0 + k * dt
        zero_counts()
        sol = mpc_fn(x, None, st, t, x)
        torch.cuda.synchronize()
        check_route(f"hybrid refine {refine}", {"apg_solve": 1, "value_batch": 0,
                                                "value_and_grad": 0, "trajectory": 0})
        w0 = time.perf_counter()
        with routed("apg_solve_kernel", AK.apg_solve_plain):
            one = mpc_fn(x, None, st, t, x)
        plain_ms.append((time.perf_counter() - w0) * 1e3)
        nk, np_ = int(sol.opt_state.num_steps), int(one.opt_state.num_steps)
        du = max(du, float((sol.u_opt - one.u_opt).abs().max()))
        steps.append(nk)
        if not (nk == np_ and torch.allclose(sol.u_opt, one.u_opt, rtol=2e-4, atol=2e-5)):
            raise AssertionError(f"hybrid refine {refine} tick {k}: kernel {nk} steps vs plain "
                                 f"{np_}, max|du| {du:.3e}")
        st, x = sol.opt_state, sol.x_evol[1]
    budget = mpc_fn(x, None, st, t0 + (warm + 1) * dt, x, 2)
    log(f"hybrid refine_iters {refine} on iris traj: cold + {warm} warm solves, kernel against "
        f"plain from the same warm starts: steps {steps}, max|du| {du:.3e} (rtol 2e-4 / atol "
        f"2e-5); iter_budget 2 -> {int(budget.opt_state.num_steps)} steps")
    if int(budget.opt_state.num_steps) != 2:
        raise AssertionError("the hybrid ignored its iteration budget")
    return {"du": du, "steps": steps, "plain_ms": statistics.median(plain_ms)}


def policy_ticks(dev, refine: int, n: int = POLICY_TICKS) -> dict:
    """``n`` chained iris traj ticks of the policy family at ``refine``:
    wall ms per solve from ``mpc_fn`` dispatch to the plan on the host
    (p50), and the device span (CUDA events) p50; the launch counts."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    c, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(
        policy_config("iris", "traj", refine), device=dev)
    dt = float(c["_time_steps"][0])
    x, t0 = policy_start(sft, dev)
    st = reset_fn(x, None, x)
    for k in range(3):                               # warm: builds, first launches
        sol = mpc_fn(x, None, st, t0, x)
        sol.u_opt.cpu()
    wall, devm, steps = [], [], []
    zero_counts()
    for k in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        sol = mpc_fn(x, None, st, t0 + k * dt, x)
        e1.record()
        sol.u_opt[0].cpu()
        wall.append((time.perf_counter() - w0) * 1e3)
        e1.synchronize()
        devm.append(e0.elapsed_time(e1))
        steps.append(float(sol.opt_state.num_steps))
        st, x = sol.opt_state, sol.x_evol[1]
    want = ({"apg_solve": n, "value_batch": 0, "value_and_grad": 0, "trajectory": 0}
            if refine else {"apg_solve": 0, "value_batch": n, "value_and_grad": 0,
                            "trajectory": n})
    got = check_route(f"policy ticks refine {refine}", want)
    return {"wall_ms_p50": statistics.median(wall), "device_ms_p50": statistics.median(devm),
            "steps": statistics.mean(steps), "launches": got}


def host_launches(fn, n: int = 10) -> dict:
    """What one call of ``fn`` asks of the card, from ``torch.profiler``
    over ``n`` calls: kernel launches (every ``cuda*Launch*`` runtime call)
    and host-to-device copies per call, and the host's CPU time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    launches = copies = 0
    for ev in prof.key_averages():
        if "Launch" in ev.key and ev.key.startswith("cuda"):
            launches += ev.count
        if ev.key.startswith("cudaMemcpy"):
            copies += ev.count
    wall = []
    for _ in range(n):
        w0 = time.perf_counter()
        fn()
        wall.append((time.perf_counter() - w0) * 1e3)
    torch.cuda.synchronize()
    return {"launches": launches / n, "copies": copies / n,
            "host_ms": statistics.median(wall)}


def policy_host_split(dev) -> dict:
    """The host's share of a pure-policy iris traj solve: launches and CPU
    time of the whole ``mpc_fn`` call and of its pieces (the network pass
    with its features; the oracle's consts; its two kernel launches)."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc, make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    cfg = policy_config("iris", "traj")
    _, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    pieces = build_mpc(copy.deepcopy(cfg), device=dev)[2]
    x, t0 = policy_start(sft, dev)
    st = reset_fn(x, None, x)
    x_ref = pieces.build_ref(torch.tensor(t0, device=dev), x)
    u_prev = st.yk[0]
    plan = pieces.policy_plan(x, x_ref, u_prev)
    oracle = lambda: CO.cost_oracle(b.model, b.params, b.cost_params, b.time_steps, x, x_ref,
                                    u_prev, None, 1, 4)
    o = oracle()
    return {"mpc_fn": host_launches(lambda: mpc_fn(x, None, st, t0, x)),
            "network": host_launches(lambda: pieces.policy_plan(x, x_ref, u_prev)),
            "oracle_consts": host_launches(oracle),
            "value_and_trajectory": host_launches(lambda: (o.value(plan), o.trajectory(plan)))}


def phase_policy(dev, card: str) -> dict:
    """Phase 21, the policy family on the card: the four shipped
    checkpoints' pure policy against the plain version, the ``refine_iters``
    hybrid (3 and 15) against the plain whole solve and its iteration
    budget, chained ticks timed, and the closed loop (the hybrid at 15
    gated at the example's PASS, the pure policy printed)."""
    import torch

    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    out = {"pure": {f"{v} {k}": policy_pure_parity(dev, v, k) for v, k in POLICY_CKPTS}}
    out["hybrid"] = {r: policy_hybrid_parity(dev, r) for r in POLICY_REFINE}
    out["ticks"] = {r: policy_ticks(dev, r) for r in (0,) + POLICY_REFINE}
    for r, tk in out["ticks"].items():
        log(f"policy ticks ({card}), iris traj, refine_iters {r}: {tk['wall_ms_p50']:.3f} ms per "
            f"solve p50 from dispatch to the plan on the host (device span "
            f"{tk['device_ms_p50']:.3f} ms) at {tk['steps']:.1f} iterations over "
            f"{POLICY_TICKS} chained ticks")
    out["host"] = policy_host_split(dev)
    log("the pure policy's host work per call (torch.profiler launches and copies; host ms "
        "p50 without the profiler): " + "; ".join(
            f"{k} {v['launches']:.0f} launches, {v['copies']:.0f} copies, {v['host_ms']:.3f} ms"
            for k, v in out["host"].items()))
    out["closed_loop"] = {}
    for refine, gated in ((15, True), (0, False)):
        zero_counts()
        res = closed_loop.run(["--seconds", str(CLOSED_LOOP_S), "--time-scale", "1",
                               "--solver", "policy", "--refine-iters", str(refine)])
        torch.cuda.synchronize()
        got = res["launches"] = counts()
        out["closed_loop"][refine] = res
        log(f"closed loop --solver policy --refine-iters {refine} ({card}): tracking error "
            f"mean {res['err_mean_m']:.4f} m max {res['err_max_m']:.4f} m; FCU status "
            f"{res['fcu_status']}; timeout ticks {res['timeout_ticks']}/{res['tracked_ticks']}; "
            f"max pickup idx {res['max_pickup_idx']}; {res['solves']} solves p50 "
            f"{res['solve_ms_p50']:.3f} ms at {res['iterations_p50']} iterations; kernel "
            f"launches {got} -> {'PASS' if res['ok'] else 'FAIL'}"
            f"{'' if gated else ' (printed, not gated: its error is the shipped checkpoint)'}")
        kernels_ok = (got["apg_solve"] >= 1 and not got["value_batch"] and not got["trajectory"]
                      if refine else not got["apg_solve"] and got["value_batch"] >= 1
                      and got["trajectory"] >= 1)
        if not kernels_ok or got["value_and_grad"]:
            raise AssertionError(f"the policy closed loop (refine {refine}) did not run on "
                                 f"its kernels")
        if gated and not res["ok"]:
            raise AssertionError(f"the hybrid closed loop failed its PASS gate: {res}")
    return out


def oracle_batch_inputs(b, pieces, B: int, dev, seed: int, P: int = 1):
    """B scenarios of one config's oracle: hover states 1 m apart at random,
    their references, previous controls, and (P > 1) antithetic Brownian
    blocks (B, P, H, 13)."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    H, n_u, nZ = int(b.time_steps.shape[0]), b.model.n_u, int(b.lb_z.shape[0])
    xs = torch.zeros(B, 13, device=dev)
    xs[:, 6] = 1.0
    xs[:, :3] = torch.from_numpy(rs.randn(B, 3).astype(np.float32)).to(dev)
    x_ref = pieces.build_ref(torch.zeros(B, device=dev), xs)
    u_prev = torch.cat([b.cost_params.uref.expand(B, n_u),
                        torch.zeros(B, nZ - n_u, device=dev)], 1).contiguous()
    noise = None
    if P > 1:
        z = torch.randn((B, P // 2, H, 13), generator=torch.Generator().manual_seed(seed))
        noise = torch.cat([z, -z], 1).to(dev)
    return xs, x_ref, u_prev, noise


def batched_oracle_check(b, pieces, dev, B: int, Ks: tuple, P: int, tag: str,
                         vg: bool, n_plain: int = 2) -> dict:
    """One config's batched oracle at B scenarios: ``value_batch`` over
    B x K plans for each K and (``vg``) ``value_and_grad`` over B plans,
    one launch each, every scenario bit-equal to its solo launch, and
    ``n_plain`` scenarios (the first and the last) within the oracle
    tolerances of the plain oracle. Returns the worst errors and the
    launches' times."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    xs, x_ref, u_prev, noise = oracle_batch_inputs(b, pieces, B, dev, B + P, P)
    H, nZ = int(b.time_steps.shape[0]), int(b.lb_z.shape[0])
    ob = CO.cost_oracle_batched(b.model, b.params, b.cost_params, b.time_steps, xs, x_ref,
                                u_prev, noise, P, 4)
    args = lambda i: (b.model, b.params, b.cost_params, b.time_steps, xs[i], x_ref[i],
                      u_prev[i], None if noise is None else noise[i], P, 4)
    solo = [CO.cost_oracle(*args(i)) for i in range(B)]
    plain = {i: CO.cost_oracle_plain(*args(i)) for i in sorted({0, B - 1})[:n_plain]}
    out = {"vb_err": 0.0, "vg_err": 0.0, "ms": {}}
    rs = np.random.RandomState(B * 7 + P)
    for K in Ks:
        U = torch.from_numpy(rs.uniform(0.35, 0.9, (B, K, H, nZ)).astype(np.float32)).to(dev)
        n0 = CO.value_batch_kernel.launches
        costs = ob.value_batch(U)
        if CO.value_batch_kernel.launches != n0 + 1:
            raise AssertionError("the batched value_batch was not one launch")
        bad = [i for i in range(B) if not torch.equal(solo[i].value_batch(U[i]), costs[i])]
        for i, o in plain.items():
            ref = o.value_batch(U[i])
            out["vb_err"] = max(out["vb_err"], float(((costs[i] - ref).abs() / ref.abs()).max()))
        out["ms"][("value_batch", K)] = per_launch_ms(lambda: ob.value_batch(U), 20)
        log(f"batched value_batch {tag} B={B} K={K}: {B - len(bad)}/{B} scenarios bit-equal to "
            f"their solo launches; plain rel {out['vb_err']:.3e} (2e-5); "
            f"{out['ms'][('value_batch', K)]:.4f} ms per launch")
        if bad or out["vb_err"] > 2e-5:
            raise AssertionError(f"batched value_batch {tag} B={B} K={K}: scenarios {bad[:8]}")
    if vg:
        u = torch.from_numpy(rs.uniform(0.35, 0.9, (B, H, nZ)).astype(np.float32)).to(dev)
        n0 = CO.value_and_grad_kernel.launches
        v, g = ob.value_and_grad(u)
        if CO.value_and_grad_kernel.launches != n0 + 1:
            raise AssertionError("the batched value_and_grad was not one launch")
        bad = []
        for i in range(B):
            v1, g1 = solo[i].value_and_grad(u[i])
            if not (torch.equal(v1, v[i]) and torch.equal(g1, g[i])):
                bad.append(i)
        for i, o in plain.items():
            vp, gp = o.value_and_grad(u[i])
            if not (torch.allclose(g[i], gp, rtol=5e-4, atol=5e-5)
                    and abs(float(v[i] - vp)) <= 2e-5 * abs(float(vp))):
                bad.append(f"plain {i}")
            out["vg_err"] = max(out["vg_err"], float((g[i] - gp).abs().max()))
        out["ms"]["value_and_grad"] = per_launch_ms(lambda: ob.value_and_grad(u), 20)
        log(f"batched value_and_grad {tag} B={B}: {B - sum(isinstance(i, int) for i in bad)}/{B} "
            f"bit-equal to their solo launches; plain max|dg| {out['vg_err']:.3e} (rtol 5e-4 / "
            f"atol 5e-5); {out['ms']['value_and_grad']:.4f} ms per launch")
        if bad:
            raise AssertionError(f"batched value_and_grad {tag} B={B}: {bad[:8]}")
    # one scenario's plain evaluation, for the record
    i = next(iter(plain))
    U1 = torch.from_numpy(rs.uniform(0.35, 0.9, (Ks[-1], H, nZ)).astype(np.float32)).to(dev)
    out["plain_ms"] = per_launch_ms(lambda: plain[i].value_batch(U1), 3)
    return out


def batched_steps(mpc_b, args_fn, n: int) -> dict:
    """``n`` batched steps from the same inputs (``args_fn()`` -> the call's
    arguments): host wall p50 from dispatch to a synchronised result, and
    device ms p50 (CUDA events)."""
    import torch

    wall, devm = [], []
    for _ in range(n):
        a = args_fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        sol = mpc_b(*a)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        devm.append(e0.elapsed_time(e1))
    return {"wall_ms_p50": statistics.median(wall), "device_ms_p50": statistics.median(devm),
            "last": sol}


def phase_batched_oracle(dev, card: str) -> dict:
    """Phase 22, the batched oracle routes: the scenario axis of
    ``value_batch`` and ``value_and_grad`` (bit-equal per scenario to the
    solo launch, plain within the oracle tolerances), the batched MPPI,
    fixed-step and policy solves each bit-equal per scenario to the solo
    ``mpc_fn`` (the network's plans to 1e-6), their steps timed, and the
    fleet demo with ``--solver policy --refine-iters 15`` and ``--solver
    mppi``."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine import goldens as G
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batch_inputs
    from sde4mbrl_px4_tpu_torch.sim import fleet_serving
    from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise

    out = {"oracle": {}}
    _, b, pieces = build_mpc(config("iris_posctrl_mpc"), device=dev)
    for B in ORACLE_B:
        out["oracle"][("P=1", B)] = batched_oracle_check(
            b, pieces, dev, B, ORACLE_K, 1, "iris posctrl P=1", vg=B in VG_B)
    _, bp, pp = build_mpc(config("iris_posctrl_mpc", particles=P_FULL), device=dev)
    out["oracle"][(f"P={P_FULL}", PART_B)] = batched_oracle_check(
        bp, pp, dev, PART_B, (1, 4), P_FULL, f"iris posctrl P={P_FULL} antithetic", vg=True)
    padded = b._replace(params=G.padded_trunk(b.params, PADDED_HID, seed=0))
    out["oracle"][("padded", PART_B)] = batched_oracle_check(
        padded, pieces, dev, PART_B, ORACLE_K, 1, f"padded trunk ({PADDED_HID} units)", vg=False)
    _, bc, pc = build_mpc(config(SHIPPED), device=dev)
    out["oracle"][("prox", PART_B)] = batched_oracle_check(
        bc, pc, dev, PART_B, ORACLE_K, 1, "proximal nZ=10", vg=True)

    # batched MPPI at B = 64, K = 64, 8 rounds, the draws handed in
    cfg = config("iris_posctrl_mpc", solver="mppi")
    reset_fn, mpc_fn, reset_b, mpc_b, _, bm = batched_pair(cfg, dev)
    xs, _ = make_batch_inputs(SOLVE_B, spread=0.5, device=dev)
    tgt = bench_targets(xs)[0]
    ts = torch.zeros(SOLVE_B, device=dev)
    eps, c0 = draw_mppi_noise(torch.Generator().manual_seed(5), MPPIConfig(), 20, 4, dev,
                              batch=(SOLVE_B,))
    st_in = reset_b(xs, None, xs)
    torch.cuda.synchronize()
    zero_counts()
    sol = mpc_b(xs, iter([(eps, c0)]), st_in, ts, tgt)
    torch.cuda.synchronize()
    out["mppi_launches"] = check_route(f"batched MPPI B={SOLVE_B}", {
        "apg_solve": 0, "value_batch": MPPIConfig().iters + 2, "value_and_grad": 0,
        "trajectory": 1})
    out["bit_equal"] = {f"MPPI B={SOLVE_B}": bit_equal_to_solo(
        f"MPPI B={SOLVE_B} (K=64, 8 rounds)", sol,
        [mpc_fn(xs[i], iter([(eps[i], c0[i])]), scenario_state(st_in, i), 0.0, tgt[i])
         for i in range(SOLVE_B)])}
    out["mppi"] = batched_steps(mpc_b, lambda: (xs, iter([(eps, c0)]), st_in, ts, tgt), 5)

    # batched fixed-step APG at B = 64 (posctrl without its linesearch
    # block, its 100-iteration budget)
    cfg = config("iris_posctrl_mpc", linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"])
    reset_fn, mpc_fn, reset_b, mpc_b, _, _ = batched_pair(cfg, dev)
    st_in = reset_b(xs, None, xs)
    torch.cuda.synchronize()
    zero_counts()
    sol = mpc_b(xs, None, st_in, ts, tgt)
    torch.cuda.synchronize()
    it = int(sol.opt_state.num_steps.max())
    out["fixed_launches"] = check_route(f"batched fixed-step B={SOLVE_B}", {
        "apg_solve": 0, "value_batch": it, "value_and_grad": it + 2, "trajectory": 1})
    solos = [mpc_fn(xs[i], None, scenario_state(st_in, i), 0.0, tgt[i]) for i in range(SOLVE_B)]
    gsq = float(max(abs(float(s.opt_state.grad_sqr) - float(sol.opt_state.grad_sqr[i]))
                    / max(abs(float(s.opt_state.grad_sqr)), 1e-30) for i, s in enumerate(solos)))
    log(f"batched fixed-step B={SOLVE_B}: grad_sqr (a sum over the plan, in torch's order "
        f"for the shape) against the solo solves: rel {gsq:.3e} (1e-6)")
    if gsq > 1e-6:
        raise AssertionError("batched fixed-step grad_sqr differs from the solo solves")
    out["bit_equal"][f"fixed-step B={SOLVE_B}"] = bit_equal_to_solo(
        f"fixed-step B={SOLVE_B}", sol, solos, skip=("grad_sqr",))
    out["fixed"] = batched_steps(mpc_b, lambda: (xs, None, st_in, ts, tgt), 3)
    out["fixed"]["steps"] = float(sol.opt_state.num_steps.mean())

    # batched fixed-step APG at P=512 antithetic, B = 4, 5 iterations: the
    # particle forms' scenario axis on a route (a cluster grid each)
    cfg = config("iris_posctrl_mpc", linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"],
                 particles=P_FULL, max_iter=5, max_no_improvement_iter=5)
    reset_fn, mpc_fn, reset_b, mpc_b, _, _ = batched_pair(cfg, dev)
    xp = xs[:PART_B]
    z = torch.stack([brownian(P_FULL, dev, antithetic=True, seed=10 + i) for i in range(PART_B)])
    st_in = reset_b(xp, None, xp)
    torch.cuda.synchronize()
    zero_counts()
    sol = mpc_b(xp, iter([z]), st_in, ts[:PART_B], tgt[:PART_B])
    torch.cuda.synchronize()
    it = int(sol.opt_state.num_steps.max())
    out["part_launches"] = check_route(f"batched fixed-step P={P_FULL} B={PART_B}", {
        "apg_solve": 0, "value_batch": it, "value_and_grad": it + 2, "trajectory": 1})
    out["bit_equal"][f"fixed-step P={P_FULL} B={PART_B}"] = bit_equal_to_solo(
        f"fixed-step P={P_FULL} antithetic B={PART_B}", sol,
        [mpc_fn(xp[i], iter([z[i]]), scenario_state(st_in, i), 0.0, tgt[i])
         for i in range(PART_B)], skip=("grad_sqr",))

    # the policy at B = 256, pure and the hybrid at refine_iters 15
    xs, _ = make_batch_inputs(POLICY_B, spread=0.5, device=dev)
    tgt, ts = bench_targets(xs)[0], torch.zeros(POLICY_B, device=dev)
    for refine in (0, 15):
        cfg = policy_config("iris", "posctrl", refine)
        reset_fn, mpc_fn, reset_b, mpc_b, _, pb = batched_pair(cfg, dev)
        _, _, pieces = build_mpc(copy.deepcopy(cfg), device=dev)
        st_in = reset_b(xs, None, xs)
        torch.cuda.synchronize()
        zero_counts()
        sol = mpc_b(xs, None, st_in, ts, tgt)
        torch.cuda.synchronize()
        tag = f"policy B={POLICY_B} refine_iters {refine}"
        out[f"policy_{refine}_launches"] = check_route(tag, (
            {"apg_solve": 1, "value_batch": 0, "value_and_grad": 0, "trajectory": 0} if refine
            else {"apg_solve": 0, "value_batch": 1, "value_and_grad": 0, "trajectory": 1}))
        x_ref = pieces.build_ref(ts, pieces.targets(tgt))
        u_prev = st_in.yk[:, 0]
        plans = pieces.policy_plan(xs, x_ref, u_prev)
        dplan = max(float((pieces.policy_plan(xs[i], x_ref[i], u_prev[i]) - plans[i]).abs().max())
                    for i in range(POLICY_B))
        bad = []
        for i in range(POLICY_B):
            if refine:
                st1, _ = AK.apg_solve_kernel(
                    pb.model, pb.params, pb.cost_params, pb.apg_config, pb.time_steps, xs[i],
                    x_ref[i], u_prev[i], None, 1, pb.lb_z, pb.ub_z, plans[i].contiguous(),
                    t_init=st_in.stepsize[i], precond=pb.precond)
                same = torch.equal(st1.yk, sol.u_opt[i]) and torch.equal(
                    st1.num_steps, sol.opt_state.num_steps[i])
            else:
                o = CO.cost_oracle(pb.model, pb.params, pb.cost_params, pb.time_steps, xs[i],
                                   x_ref[i], u_prev[i], None, 1, 4)
                same = (torch.equal(o.value(plans[i].contiguous()), sol.opt_state.opt_cost[i])
                        and torch.equal(o.trajectory(plans[i].contiguous()), sol.x_evol[i])
                        and torch.equal(plans[i], sol.u_opt[i]))
            if not same:
                bad.append(i)
        log(f"batched {tag}: the network's plans against each scenario's solo pass max|du| "
            f"{dplan:.3e} (1e-6); the kernels given the batch's plans: {POLICY_B - len(bad)}/"
            f"{POLICY_B} scenarios bit-equal to their solo launches")
        if bad or dplan > 1e-6:
            raise AssertionError(f"batched {tag}: scenarios {bad[:8]} differ")
        if refine:
            # a warm step: every scenario past its cold start, the network's
            # plans selected away; each scenario its solo mpc_fn, bit for bit
            st_w = sol.opt_state
            sol_w = mpc_b(xs, None, st_w, ts, tgt)
            out["bit_equal"][f"hybrid warm B={POLICY_B}"] = bit_equal_to_solo(
                f"hybrid refine_iters 15 B={POLICY_B}, a warm step", sol_w,
                [mpc_fn(xs[i], None, scenario_state(st_w, i), 0.0, tgt[i])
                 for i in range(POLICY_B)])
        out[f"policy_{refine}"] = batched_steps(
            mpc_b, lambda: (xs, None, st_in, ts, tgt), 5)
        out[f"policy_{refine}"]["dplan"] = dplan
    for key, B in (("mppi", SOLVE_B), ("fixed", SOLVE_B), ("policy_0", POLICY_B),
                   ("policy_15", POLICY_B)):
        r = out[key]
        r["solves_per_s"] = B / r["wall_ms_p50"] * 1e3
        log(f"batched {key} B={B} ({card}): {r['wall_ms_p50']:.3f} ms per step p50 (device "
            f"{r['device_ms_p50']:.3f} ms), {r['solves_per_s']:.0f} solves/s")

    out["fleet"] = {}
    for tag, argv, want in (
            ("policy 15", ["--solver", "policy", "--refine-iters", "15"],
             lambda n: {"apg_solve": n, "value_batch": 0, "value_and_grad": 0, "trajectory": 0}),
            ("mppi", ["--solver", "mppi"],
             lambda n: {"apg_solve": 0, "value_batch": n * (MPPIConfig().iters + 2),
                        "value_and_grad": 0, "trajectory": n})):
        zero_counts()
        res = fleet_serving.run(FLEET_FAMILY_ARGV + argv)
        torch.cuda.synchronize()
        res["launches"] = check_route(f"fleet {tag}", want(res["ticks"]))
        out["fleet"][tag] = res
        log(f"fleet demo --solver {tag} ({card}; {res['vehicles']} vehicles, {res['ticks']} "
            f"ticks): busy p50 {res['busy_ms_p50']:.3f} ms, p99 {res['busy_ms_p99']:.3f} ms, a "
            f"tick's device time p50 {res['device_ms_p50']:.3f} ms, plan age p50 "
            f"{res['age_ms_p50']:.3f} ms; tracking mean {res['err_mean']:.4f} m max "
            f"{res['err_max']:.4f} m -> {'PASS' if res['ok'] else 'FAIL'}")
        if not (res["ok"] and res["first_age"] == 0.0 and res["age_ms_p50"] > 0.0):
            raise AssertionError(f"the fleet demo --solver {tag} failed: {res}")
    out["n_consts"] = {"pos": n_consts(b, dev), "prox": n_consts(bc, dev, True)}
    out["bundles"] = {"pos": b, "part": bp, "prox": bc}
    return out


# the particle options (phases 23-24): examples/uncertainty_mpc.py's
# state-noise stds and risk, the cases their kernel branches are held on,
# MPPI over K x P paths, the batched route's scenarios
OPTION_STD = [0.15] * 3 + [0.1] * 3 + [0.0] * 4 + [0.05] * 3
RISK = 2.0
MPPI_K, MPPI_P = 64, 128
OPTION_B = 4
P_LARGE = 1024             # two chunks a block of the particle forms (Pc = 32, C = 16)
UNCERTAINTY_P = 1024       # examples/uncertainty_mpc.py's --particles (BASELINE config 4)
ROBUST_ARGV = ["--seconds", "4", "--seeds", "1"]   # a short sim/noise_robustness.py


def option_cases(dev) -> list:
    """The cases the particle options' kernel branches are held on: (tag,
    bundle, chunk, problem, plans(K, seed), option sets). ``p512anti`` (one
    chunk a block), P=1024 antithetic (two chunks a block), the altitude
    floor's ``<true, penalty>`` at P=128 and the proximal form at P=64 in
    chunks of 16."""
    from sde4mbrl_px4_tpu_torch.engine.goldens import constrained_plans, constrained_problem
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config

    every = (("risk",), ("starts",), ("risk", "starts"))
    b1 = make_mpc_from_config(config("iris_traj_mpc", particles=P_FULL), device=dev)[3]
    b2 = make_mpc_from_config(config("iris_posctrl_mpc", particles=P_LARGE), device=dev)[3]
    b3 = floor_mpc(floor_config(), dev)[3]
    b4 = make_mpc_from_config(constrained_config("prox", particles=64), device=dev)[3]
    return [
        (f"p512anti (iris_traj_mpc, P={P_FULL} antithetic)", b1, 0, problem(b1, dev),
         lambda K, seed: plans(K, seed, dev), every),
        (f"P={P_LARGE} antithetic (iris_posctrl_mpc, 2 chunks a block)", b2, 0,
         problem(b2, dev),
         lambda K, seed: plans(K, seed, dev), every),
        (f"altitude floor <true, penalty>, P={P_FLOOR} antithetic", b3, 0,
         constrained_problem(b3), lambda K, seed: constrained_plans(b3, K, seed),
         (("risk",), ("risk", "starts"))),
        ("proximal (nZ=10), P=64 in chunks of 16", b4, 16, constrained_problem(b4),
         lambda K, seed: constrained_plans(b4, K, seed), (("risk",), ("risk", "starts"))),
    ]


def with_options(b, opts, x0, P: int, dev, seed: int):
    """(cost with ``risk_lambda`` where ``opts`` has risk, the (P, 13) starts
    of the example's state-noise stds where it has starts, or None)."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_start_spread, particle_starts

    cp = b.cost_params._replace(risk_lambda=RISK) if "risk" in opts else b.cost_params
    starts = None
    if "starts" in opts:
        z0 = draw_start_spread(torch.Generator().manual_seed(seed), P, True, dev)
        starts = particle_starts(x0, torch.tensor(OPTION_STD, device=dev), z0).contiguous()
    return cp, starts


def phase_particle_options(dev, card: str) -> dict:
    """Phase 23: the particle options' branches of kernels #1-#3 against
    their plain versions on the same draws (``option_cases``): the whole
    solve at a fixed 5 iterations (the particle tolerances, equal steps),
    ``value_batch`` K = 1, 4 and ``value_and_grad`` (values 5e-4, gradients
    5e-4 / 5e-5), with risk (lambda 2), the example's starts, and both; each
    case's risk-and-starts solve, ``value_batch`` and ``value_and_grad`` on
    their cluster against C = 1 bit for bit; then the new branches timed:
    the fixed 5-iteration P=512 solve without and with each option, P=1024
    without and with risk, and the oracle kernels per launch at P=512."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    err = {"apg_solve": 0.0, "value_batch": 0.0, "value_and_grad": 0.0}
    out = {"cases": {}}
    cases = option_cases(dev)
    for tag, b, chunk, (x0, x_ref, u_prev, u_init), make_plans, option_sets in cases:
        P = b.num_particles
        z = brownian(P, dev, antithetic=True)
        apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
        for i, opts in enumerate(option_sets):
            cp, starts = with_options(b, opts, x0, P, dev, seed=P + i)
            what = " + ".join(opts)
            t = f"{tag}, {what}"
            args = (b.model, b.params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P,
                    b.lb_z, b.ub_z, u_init)
            du, _, steps = particle_solve_parity(AK, b, args, chunk, t, "option solve",
                                                 starts=starts)
            err["apg_solve"] = max(err["apg_solve"], du)
            oargs = (b.model, b.params, cp, b.time_steps, x0, x_ref, u_prev, z, P,
                     b.apg_config.maxls)
            kern = CO.cost_oracle(*oargs, chunk=chunk, starts=starts)
            plain = CO.cost_oracle_plain(*oargs, chunk=chunk, starts=starts)
            U = make_plans(4, P + i)
            for k, e in particle_oracle_parity(kern, plain, U, t, "option oracle",
                                               vtol=PART_RTOL).items():
                err[k] = max(err[k], e)
            out["cases"][t] = {"steps": steps, "max_du": du}
            if opts != ("risk", "starts"):
                continue
            cluster_vs_one(AK, args, chunk, b.precond, t, starts=starts)
            one = CO.cost_oracle(*oargs, chunk=chunk, cluster=1, starts=starts)
            for Ub in (U[:1], U):
                batch_cluster_vs_one(kern, one, Ub, t)
            (v_c, g_c), (v_1, g_1) = kern.value_and_grad(U[1]), one.value_and_grad(U[1])
            torch.cuda.synchronize()
            log(f"value_and_grad {t}, its cluster against C = 1: |dv| "
                f"{abs(float(v_c - v_1)):.3e}, max|dg| {float((g_c - g_1).abs().max()):.3e} "
                f"(equal bits)")
            if not (torch.equal(v_c, v_1) and torch.equal(g_c, g_1)):
                raise AssertionError(f"value_and_grad moves with its cluster size ({t})")

    # the new branches timed against the forms without them, on one card
    for _, b, _, (x0, x_ref, u_prev, u_init), _, _ in cases[:2]:
        P = b.num_particles
        z = brownian(P, dev, antithetic=True)
        apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
        sets = ((), ("risk",), ("starts",), ("risk", "starts")) if P == P_FULL else \
            ((), ("risk",))
        timed = {}
        for opts in sets:
            cp, starts = with_options(b, opts, x0, P, dev, seed=7)
            args = (b.model, b.params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P,
                    b.lb_z, b.ub_z, u_init)
            timed[" + ".join(opts) or "none"] = time_fixed(
                AK, args, b.precond, n_kernel=10, n_plain=1 if opts else 0, starts=starts)
        base = timed["none"][0]
        log(f"fixed 5-iteration solve + trajectory at P={P} antithetic ({card}): "
            + "; ".join(f"{k} {v[0]:.4f} ms ({v[0] / base:.3f}x"
                        + (f", plain {v[1]:.1f} ms)" if v[1] else ")")
                        for k, v in timed.items()))
        out[f"fixed_P{P}"] = timed
    b = cases[0][1]
    x0, x_ref, u_prev, _ = cases[0][3]
    z = brownian(P_FULL, dev, antithetic=True)
    oracle_ms = {}
    for opts in ((), ("risk",), ("starts",), ("risk", "starts")):
        cp, starts = with_options(b, opts, x0, P_FULL, dev, seed=7)
        oargs = (b.model, b.params, cp, b.time_steps, x0, x_ref, u_prev, z, P_FULL,
                 b.apg_config.maxls)
        kern = CO.cost_oracle(*oargs, starts=starts)
        plain = CO.cost_oracle_plain(*oargs, starts=starts)
        U = plans(4, 3, dev)
        key = " + ".join(opts) or "none"
        oracle_ms[key] = {
            "value_batch_K1": per_launch_ms(lambda: kern.value_batch(U[:1]), 20),
            "value_batch_K4": per_launch_ms(lambda: kern.value_batch(U), 20),
            "value_and_grad": per_launch_ms(lambda: kern.value_and_grad(U[0]), 20),
            "plain_value_batch_K1": per_launch_ms(lambda: plain.value_batch(U[:1]), 2),
            "plain_value_and_grad": per_launch_ms(lambda: plain.value_and_grad(U[0]), 2)}
    log(f"the oracle kernels per launch at P={P_FULL} antithetic ({card}; CUDA events, mean "
        f"of 20, plain of 2): " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in r.items())
            for k, r in oracle_ms.items()))
    out["oracle_ms"] = oracle_ms
    out["err"] = err
    out["bundle"] = b

    # the shared-memory step of the P=1 value_batch (a trunk outside the
    # register layout: phase 4's, padded to 72 units), timed beside its bound
    from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk

    bp = make_bundle("iris_posctrl_mpc", dev)
    bp = bp._replace(params=padded_trunk(bp.params, PADDED_HID, seed=0))
    x0, x_ref, u_prev, _ = problem(bp, dev)
    oargs = (bp.model, bp.params, bp.cost_params, bp.time_steps, x0, x_ref, u_prev, None, 1, 4)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    U = plans(64, 64, dev)
    nc = n_consts(bp, dev)
    out["padded"] = {"ms": per_launch_ms(lambda: kern.value_batch(U), 20),
                     "plain_ms": per_launch_ms(lambda: plain.value_batch(U), 2),
                     "bound": bound(bp, "value_batch", nc, K=64)}
    log(f"value_batch<false, none, false> (the shared-memory step) on the trunk padded to "
        f"{PADDED_HID} units, K=64 ({card}): {out['padded']['ms']:.4f} ms per launch, plain "
        f"{out['padded']['plain_ms']:.2f} ms, bound {out['padded']['bound'][0]:.2e} ms "
        f"({out['padded']['bound'][1]})")
    return out


def phase_particle_option_routes(dev, card: str) -> dict:
    """Phase 24: the particle options through the entry points, each route's
    launch counts zeroed just before it and read just after:

    - MPPI over K x P paths: 4 chained solves of iris posctrl with ``solver:
      mppi`` (K = 64, 8 rounds) at P = 128 antithetic from the pinned
      offset, through the kernels (one particle ``value_batch`` a round, the
      warm start's and the result's) and through the plain oracle on the
      same draws (|du| <= 1e-4 per row, equal steps); per-launch time;
    - the fixed-step route with risk and starts at P = 512 (posctrl without
      its linesearch block): ``value_and_grad`` and ``value_batch`` K = 1 a
      step;
    - the batched route: B = 4 fixed 5-iteration P = 512 traj solves with
      risk and starts in one launch (and one ``trajectory``), each scenario
      bit-equal to its solo ``mpc_fn``; the batched oracle's ``value_batch``
      (K = 4) and ``value_and_grad`` bit-equal to their solo launches;
    - ``sim/uncertainty.py`` at P = 1024 (every variant's ms per solve);
    - a short ``sim/noise_robustness.py`` (4 s x 1 seed; gate: every reading
      finite; its violation fractions printed);
    - the single-solve back-off of ``tests/test_noise_robustness.py``: the
      risk-averse (and the P=32 particle) planner's terminal z at least
      0.01 m above the mean planner's (gated)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned, ned2enu
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc, make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_start_spread
    from sde4mbrl_px4_tpu_torch.sim import noise_robustness as NR
    from sde4mbrl_px4_tpu_torch.sim import uncertainty as UNC

    out = {"launches": {}}
    # MPPI over K x P paths
    n, iters = 4, 8
    cfg = config("iris_posctrl_mpc", solver="mppi", particles=MPPI_P,
                 mppi={"samples": MPPI_K, "iters": iters})
    zero_counts()
    rows_k, ms = chain(cfg, dev, n)
    torch.cuda.synchronize()
    out["launches"]["mppi"] = check_route(
        f"MPPI K={MPPI_K} x P={MPPI_P}", {"apg_solve": 0, "value_batch": n * (iters + 2),
                                          "value_and_grad": 0, "trajectory": n})
    with routed("cost_oracle", CO.cost_oracle_plain):
        rows_p, ms_p = chain(cfg, dev, n)
    du = np.abs(rows_k[:, :-1] - rows_p[:, :-1]).max(axis=1)
    log(f"MPPI K={MPPI_K} x P={MPPI_P} antithetic ({n} chained solves, {iters} rounds), "
        f"kernels vs plain, same draws: max|du| per row {np.array2string(du, precision=3)} "
        f"(gate 1e-4); wall ms per solve {statistics.median(ms[1:]):.3f} (plain "
        f"{statistics.median(ms_p[1:]):.1f})")
    if not ((du <= 1e-4).all() and np.array_equal(rows_k[:, -1], rows_p[:, -1])
            and np.isfinite(rows_k).all()):
        raise AssertionError("MPPI over K x P paths disagrees with the plain oracle")
    b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)[3]
    x0, x_ref, u_prev, _ = problem(b, dev)
    oargs = (b.model, b.params, b.cost_params, b.time_steps, x0, x_ref, u_prev,
             brownian(MPPI_P, dev, antithetic=True), MPPI_P, 4)
    kern, plain = CO.cost_oracle(*oargs), CO.cost_oracle_plain(*oargs)
    U = plans(MPPI_K, 11, dev)
    out["mppi"] = {"wall_ms_p50": statistics.median(ms[1:]),
                   "plain_wall_ms_p50": statistics.median(ms_p[1:]),
                   "max_du": float(du.max()), "bundle": b,
                   "ms": per_launch_ms(lambda: kern.value_batch(U), 20),
                   "plain_ms": per_launch_ms(lambda: plain.value_batch(U), 2)}
    log(f"value_batch K={MPPI_K} x P={MPPI_P} ({card}): {out['mppi']['ms']:.4f} ms per launch "
        f"(CUDA events, mean of 20), plain {out['mppi']['plain_ms']:.2f} ms")

    # the fixed-step route with risk and starts
    cfg = config("iris_posctrl_mpc", linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"],
                 particles=P_FULL, max_iter=20, max_no_improvement_iter=20)
    cfg["cost_params"]["risk_lambda"] = RISK
    cfg["initial_state_std"] = OPTION_STD
    n = 2
    zero_counts()
    rows, _ = chain(cfg, dev, n)
    torch.cuda.synchronize()
    steps = int(rows[:, -1].sum())
    out["launches"]["fixed_step"] = check_route(
        f"fixed-step P={P_FULL} with risk and starts",
        {"apg_solve": 0, "value_batch": steps, "value_and_grad": steps + 2 * n, "trajectory": n})
    if not np.isfinite(rows).all():
        raise AssertionError("the fixed-step route with risk and starts returned a bad plan")

    # the batched route: B scenarios with risk and starts
    pcfg = config("iris_traj_mpc", particles=P_FULL, max_iter=5)
    pcfg["cost_params"]["risk_lambda"] = RISK
    pcfg["initial_state_std"] = OPTION_STD
    # the hover_diag metric is keyed on the cost: a risk cost has no
    # committed cache, and the port does not probe one (ROADMAP item 12)
    del pcfg["apg_mpc"]["precond"]
    reset_fn, mpc_fn, reset_b, mpc_b, sft, pb = batched_pair(pcfg, dev)
    ts = torch.tensor([3.0 + 0.5 * i for i in range(OPTION_B)], device=dev)
    xs = enu2ned(sft(ts))
    z = torch.stack([brownian(P_FULL, dev, antithetic=True, seed=i) for i in range(OPTION_B)])
    z0 = draw_start_spread(torch.Generator().manual_seed(5), P_FULL, True, dev,
                           batch=(OPTION_B,))
    st_in = reset_b(xs, None, xs)
    torch.cuda.synchronize()
    zero_counts()
    sol = mpc_b(xs, iter([(z, z0)]), st_in, ts, xs)
    torch.cuda.synchronize()
    out["launches"]["batched"] = check_route(
        f"batched P={P_FULL} B={OPTION_B} with risk and starts",
        {"apg_solve": 1, "value_batch": 0, "value_and_grad": 0, "trajectory": 1})
    out["bit_equal"] = bit_equal_to_solo(
        f"P={P_FULL} antithetic B={OPTION_B} with risk and starts", sol,
        [mpc_fn(xs[i], iter([(z[i], z0[i])]), scenario_state(st_in, i), float(ts[i]), xs[i])
         for i in range(OPTION_B)])
    from sde4mbrl_px4_tpu_torch.ops.rollout import particle_starts

    starts = particle_starts(xs, torch.tensor(OPTION_STD, device=dev), z0).contiguous()
    x_refs = build_mpc(copy.deepcopy(pcfg), device=dev)[2].build_ref(ts, xs)
    u_prev = st_in.yk[:, 0].contiguous()
    ob = CO.cost_oracle_batched(pb.model, pb.params, pb.cost_params, pb.time_steps, xs,
                                x_refs, u_prev, z, P_FULL, 4, starts=starts)
    Ub = torch.stack([plans(4, 20 + i, dev) for i in range(OPTION_B)])
    vb, (vv, vg) = ob.value_batch(Ub), ob.value_and_grad(Ub[:, 0].contiguous())
    same = 0
    for i in range(OPTION_B):
        o = CO.cost_oracle(pb.model, pb.params, pb.cost_params, pb.time_steps, xs[i],
                           x_refs[i], u_prev[i], z[i], P_FULL, 4, starts=starts[i])
        v1, (a1, g1) = o.value_batch(Ub[i]), o.value_and_grad(Ub[i, 0])
        same += int(torch.equal(v1, vb[i]) and torch.equal(a1, vv[i]) and torch.equal(g1, vg[i]))
    log(f"batched oracle P={P_FULL} B={OPTION_B} with risk and starts: value_batch K=4 and "
        f"value_and_grad bit-equal to their solo launches in {same}/{OPTION_B} scenarios")
    if same != OPTION_B:
        raise AssertionError("the batched oracle with risk and starts differs from solo")

    # sim/uncertainty.py at P = 1024
    zero_counts()
    unc = UNC.run(UNCERTAINTY_P, dev)
    torch.cuda.synchronize()
    nv = len(UNC.VARIANTS)
    out["launches"]["uncertainty"] = check_route(
        f"sim/uncertainty.py P={UNCERTAINTY_P}",
        {"apg_solve": 2 * nv, "value_batch": 0, "value_and_grad": 0, "trajectory": 2 * nv})
    if not all(np.isfinite([r["ms"], r["opt_cost"]]).all() for r in unc.values()):
        raise AssertionError("sim/uncertainty.py gave a non-finite reading")
    out["uncertainty"] = unc

    # a short sim/noise_robustness.py
    zero_counts()
    robust = NR.run(ROBUST_ARGV)
    torch.cuda.synchronize()
    # the drive's ticks a controller (int(seconds / dt), dt the float32 period,
    # as the example counts them) and its warm solve
    ticks = int(float(ROBUST_ARGV[1]) / float(np.float32(0.05))) + 1
    out["launches"]["noise_robustness"] = check_route(
        "sim/noise_robustness.py " + " ".join(ROBUST_ARGV),
        {"apg_solve": 3 * ticks, "value_batch": 0, "value_and_grad": 0,
         "trajectory": 2 * ticks})
    if not robust["finite"]:
        raise AssertionError("sim/noise_robustness.py gave a non-finite reading")
    out["noise_robustness"] = {k: list(v) for k, v in robust["table"].items()}

    # the single-solve back-off of tests/test_noise_robustness.py
    def terminal_z(mut):
        cfg = floor_config(**{"max_iter": 60})
        cfg.update(num_particles=1, antithetic=False)
        cfg.update(mut)
        _, (reset_fn, mpc_fn), _, _ = floor_mpc(cfg, dev)
        tgt = hover_state(dev)
        tgt[2] = -1.25
        tgt_enu = ned2enu(tgt)
        gen = torch.Generator().manual_seed(0)
        sol = mpc_fn(tgt, gen, reset_fn(tgt, gen, tgt_enu), 0.0, tgt_enu)
        return float(sol.x_evol[-5:, 2].mean())

    cp = floor_config()["cost_params"]
    zs = {"mean": terminal_z({}),
          "particles": terminal_z({"num_particles": 32, "antithetic": True}),
          "risk": terminal_z({"num_particles": 32, "antithetic": True,
                              "cost_params": dict(cp, risk_lambda=RISK)})}
    log(f"the floor back-off, one solve 5 cm above the floor: terminal NED z mean "
        f"{zs['mean']:.4f}, P=32 particles {zs['particles']:.4f}, risk-averse "
        f"{zs['risk']:.4f} (gate: each below mean - 0.01)")
    if not (zs["particles"] < zs["mean"] - 0.01 and zs["risk"] < zs["mean"] - 0.01):
        raise AssertionError("the risk-averse plan does not back off the floor")
    out["floor_backoff"] = zs
    return out


# ---- phase 25: the learning loop -------------------------------------------
LEARN_LOG_S = 6.0        # the closed loop whose log the trainer reads
LEARN_SDE_STEPS = 300    # train_sde steps on that log
LEARN_TICKS = 40         # chained traj solves on the retrained checkpoint
LABEL_SOLO = 8           # label scenarios held bit for bit to their solo solves
PROBE_RTOL = 1e-4        # the probe against the committed file (the CPU tests' bound)


def learning_log(td: str, card: str) -> dict:
    """(a) the iris closed loop on the card writing one flight to ``.npz``
    and ``.ulg``; both read back and agree (state bit for bit, time to a
    microsecond, commands and achieved motors)."""
    import numpy as np

    from sde4mbrl_px4_tpu_torch.io.flight_log import load_flight_log
    from sde4mbrl_px4_tpu_torch.io.ulog import read_ulog, ulog_to_flight_log
    from sde4mbrl_px4_tpu_torch.sim import closed_loop

    npz, ulg = os.path.join(td, "flight.npz"), os.path.join(td, "flight.ulg")
    zero_counts()
    res = closed_loop.run(["--seconds", str(LEARN_LOG_S), "--time-scale", "1",
                           "--log", npz, "--log", ulg])
    got = counts()
    a, b = load_flight_log(npz), ulog_to_flight_log(ulg)
    cmd = read_ulog(ulg)["data"]["mpc_motors_cmd"]
    agree = (np.array_equal(a["state"], b["state"])
             and np.allclose(a["t"] - a["t"][0], b["t"], atol=2e-6)   # ULog time from 0
             and np.array_equal(a["motors"], b["cmd_motors"][:, :4])
             and np.array_equal(a["cmd_motors"], cmd["motor_val_des"])
             and np.array_equal(a["cmd_thrust_rates"], b["cmd_thrust_rates"]))
    commanded = int((np.abs(a["cmd_motors"]).sum(axis=1) > 0).sum())
    log(f"phase 25a: closed loop with --log .npz and .ulg ({card}): {res['log_records']} "
        f"records, {commanded} commanded; error mean {res['err_mean_m']:.4f} m; the two "
        f"files agree: {agree}; launches {got} -> {'PASS' if res['ok'] else 'FAIL'}")
    if not (res["ok"] and agree and commanded > 100 and got["apg_solve"] >= 1):
        raise AssertionError(f"the logged closed loop failed: {res}, agree {agree}")
    return {"records": res["log_records"], "commanded": commanded, "agree": agree,
            "err_mean_m": res["err_mean_m"], "launches": got, "npz": npz}


def learning_train(dev, td: str, npz: str, card: str) -> dict:
    """(b) ``sim/train_model.py`` at the example's size (gate: its PASS),
    then ``train_sde`` on the log of (a) from the shipped checkpoint with its
    motor gains moved by +5 % (gate: the loss on a fixed batch falls);
    steps per second of both."""
    import torch

    from sde4mbrl_px4_tpu_torch.learning.trainer import (
        TrainConfig, TrajectoryDataset, make_loss_fn, train_sde)
    from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
    from sde4mbrl_px4_tpu_torch.sim import train_model

    ckpt = os.path.join(td, "iris_sde_trained.pkl")
    zero_counts()
    ex = train_model.run(["--out", ckpt])
    log(f"phase 25b: sim/train_model.py ({card}): {ex['samples']} samples, "
        f"{ex['train_steps']} steps in {ex['train_s']:.2f} s = {ex['steps_per_s']:.1f} steps/s; "
        f"20-step error prior {ex['e_prior']:.4f} -> trained {ex['e_train']:.4f} (gate "
        f"< 0.8 x prior) -> {'PASS' if ex['ok'] else 'FAIL'}")
    if not ex["ok"] or any(counts().values()):
        raise AssertionError(f"sim/train_model.py failed (or launched a kernel): {ex}")
    model = NeuralSDE.for_vehicle(iris_config(), dev)
    tree, _ = load_params(os.path.join(ROOT, "configs/models/iris_sde.pkl"))
    # the plant flew the shipped model: start re-identifying from its motor
    # gains moved by +5 % (tests/test_learning.py::test_sysid_from_flight_log)
    tree["motor"]["log_gain"] = tree["motor"]["log_gain"] + 0.05
    cfg = TrainConfig(window=6, batch_size=64, steps=LEARN_SDE_STEPS, lr=1e-3)
    ds = TrajectoryDataset.from_flight_log(npz, window=cfg.window)
    loss_fn = make_loss_fn(model, ds.dt, cfg)
    fixed = [torch.from_numpy(a).to(dev) for a in next(ds.batches(256, seed=11))]
    with torch.no_grad():
        before = float(loss_fn(params_from_numpy(tree, dev), *fixed))
    torch.cuda.synchronize()
    t = time.perf_counter()
    fitted, met = train_sde(model, tree, ds, cfg, log_every=0, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    with torch.no_grad():
        after = float(loss_fn(fitted, *fixed))
    log(f"phase 25b: train_sde on the log of (a) ({len(ds.x0)} windows of {cfg.window}, batch "
        f"{cfg.batch_size}): {cfg.steps} steps in {secs:.2f} s = {cfg.steps / secs:.1f} steps/s; "
        f"loss on a fixed batch {before:.4f} -> {after:.4f}")
    if not after < before:
        raise AssertionError("train_sde on the flight log did not lower the loss")
    return {"example": ex, "ckpt": ckpt, "log_windows": len(ds.x0), "log_steps": cfg.steps,
            "log_s": secs, "log_steps_per_s": cfg.steps / secs, "loss_before": before,
            "loss_after": after}


def learning_probe(dev, ckpt: str, card: str) -> dict:
    """(c) the probe on the card: ``iris_traj_mpc.yaml`` against its committed
    file (rtol ``PROBE_RTOL``); then the retrained checkpoint of (b), which
    misses the cache, is probed at build and flies ``LEARN_TICKS`` chained
    traj solves (one ``apg_solve`` launch each), and its fixed 10-iteration
    solve against the plain whole solve."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader as L
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    b = make_bundle("iris_traj_mpc", dev)
    H = int(b.time_steps.shape[0])
    x_ref = enu2ned(b.state_from_traj(b.knot_times))
    z = b.cost_params.uref.expand(H, 4).contiguous()
    probe_ms = []
    for _ in range(2):                                  # the first call, then again
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = L.hover_diag_probe(b.model, b.params, b.cost_params, b.time_steps, x_ref, z)
        probe_ms.append((time.perf_counter() - t) * 1e3)
    rel = float(np.max(np.abs(d / b.precond.cpu().numpy() - 1.0)))
    log(f"phase 25c: hover_diag probe of iris_traj_mpc.yaml on the card ({card}): "
        f"{probe_ms[0]:.1f} ms, again {probe_ms[1]:.1f} ms ({H * 4} HVPs, vmapped); against "
        f"the committed file max rel {rel:.3e} (gate {PROBE_RTOL})")
    if not rel <= PROBE_RTOL:
        raise AssertionError("the card's probe disagrees with the committed file")
    cfg = load_yaml_config(os.path.join(ROOT, "configs/iris_traj_mpc.yaml"))
    cfg["learned_model_params"] = ckpt
    t = time.perf_counter()
    c, (reset_fn, mpc_fn), sft, rb = L.make_mpc_from_config(cfg, device=dev)
    build_s = time.perf_counter() - t
    env = os.environ["SDE4MBRL_PRECOND_CACHE"]
    written = sorted(f for f in os.listdir(env) if f.endswith(".npy"))
    differs = not torch.equal(rb.precond, b.precond)
    dt = float(c["_time_steps"][0])
    x = enu2ned(sft(0.0))
    st = reset_fn(x, None, x)
    mpc_fn(x, None, st, 0.0, x)                          # warm
    torch.cuda.synchronize()
    zero_counts()
    wall, dev_ms, steps, errs = [], [], [], []
    for k in range(LEARN_TICKS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        sol = mpc_fn(x, None, st, k * dt, x)
        e1.record()
        steps.append(int(sol.opt_state.num_steps))
        wall.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        st, x = sol.opt_state, sol.x_evol[1]
        errs.append(float(torch.linalg.norm(x[:3] - enu2ned(sft((k + 1) * dt))[:3])))
    got = check_route("retrained checkpoint traj", {
        "apg_solve": LEARN_TICKS, "value_batch": 0, "value_and_grad": 0, "trajectory": 0})
    # its fixed 10-iteration solve, kernel against the plain whole solve
    apg = rb.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    x0, xr, u_prev, u_init = problem(rb, dev)
    args = (rb.model, rb.params, rb.cost_params, apg, rb.time_steps, x0, xr, u_prev, None, 1,
            rb.lb, rb.ub, u_init)
    st_k, _ = AK.apg_solve_kernel(*args, precond=rb.precond)
    st_p, _ = AK.apg_solve_plain(*args, precond=rb.precond)
    du = float((st_k.yk - st_p.yk).abs().max())
    same = (int(st_k.num_steps) == int(st_p.num_steps)
            and bool(torch.allclose(st_k.yk, st_p.yk, rtol=2e-4, atol=2e-5)))
    k_ms, p_ms = time_fixed(AK, args, rb.precond, n_plain=1)
    out = {"probe_ms": probe_ms, "committed_max_rel": rel, "build_s": build_s,
           "written": written, "metric_differs": differs, "launches": got["apg_solve"],
           "wall_ms_p50": statistics.median(wall), "device_ms_p50": statistics.median(dev_ms),
           "iterations_p50": statistics.median(steps), "iterations": steps[:8],
           "err_mean_m": float(np.mean(errs)), "fixed_du": du, "fixed_ms": k_ms,
           "fixed_plain_ms": p_ms, "n_consts": n_consts(rb, dev),
           "bundle": rb}
    log(f"phase 25c: the retrained checkpoint built in {build_s:.2f} s with its probed metric "
        f"({written}; differs from the shipped one: {differs}); {LEARN_TICKS} chained traj "
        f"solves: wall p50 {out['wall_ms_p50']:.3f} ms, device p50 {out['device_ms_p50']:.3f} "
        f"ms at {out['iterations_p50']} iterations (first {steps[:4]}); tracking error of "
        f"x_evol[1] mean {out['err_mean_m']:.4f} m; fixed 10 it. kernel vs plain max|du| "
        f"{du:.3e}, {k_ms:.4f} / {p_ms:.1f} ms")
    if not (len(written) == 1 and differs and same and np.isfinite(errs).all()):
        raise AssertionError(f"the retrained checkpoint's route failed: {out}")
    return out


def label_wrapper(TD, calls: list):
    """``learning/distill.py::label_states`` wrapped: each call's states,
    its ``apg_solve`` launches (the difference of the count around it: the
    main path's count is not reset), its wall time with the card synced,
    and its first ``LABEL_SOLO`` scenarios' inputs and labels."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK

    orig = TD.label_states

    def wrapped(cfg, xs, ts, xdes, rng=None, dcfg=TD.DistillConfig(), mesh=None, u_prevs=None,
                device=None):
        torch.cuda.synchronize()
        n0, t = AK.apg_solve_kernel.launches, time.perf_counter()
        lab = orig(cfg, xs, ts, xdes, rng, dcfg, mesh, u_prevs, device)
        torch.cuda.synchronize()
        n = int(xs.shape[0])
        calls.append({"cfg": cfg, "dcfg": dcfg, "n": n,
                      "kind": "traj" if cfg.get("trajectory_path") else "posctrl",
                      "launches": AK.apg_solve_kernel.launches - n0,
                      "s": time.perf_counter() - t,
                      "solo": [a[:LABEL_SOLO].clone() for a in (xs, ts, xdes, u_prevs)],
                      "labels": lab[:LABEL_SOLO].clone()})
        return lab

    return orig, wrapped


def label_solo_bits(call: dict, dev) -> int:
    """The first ``LABEL_SOLO`` scenarios of a label call, each solved alone
    through the expert's ``mpc_fn`` (the whole solve at B = 1) from the same
    warm start: the number whose plan equals its label bit for bit."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.learning.distill import _expert_cfg

    _, (reset_fn, mpc_fn), _, b = make_mpc_from_config(
        _expert_cfg(call["cfg"], call["dcfg"]), device=dev)
    equal = 0
    for i, (x, t, xd, up) in enumerate(zip(*call["solo"])):
        st = reset_fn(x, None, xd)
        yk = st.yk.clone()
        yk[0, :b.model.n_u] = up
        sol = mpc_fn(x, None, st._replace(yk=yk), t, xd)
        equal += int(torch.equal(sol.u_opt, call["labels"][i]))
    return equal


def label_launch(cfg: dict, dcfg, dev, n: int) -> dict:
    """One label launch of ``n`` sampled states re-run for its device time
    (CUDA events around the batched solve: one ``apg_solve`` launch),
    iterations and bound inputs; and one of its scenarios at a 10-iteration
    budget, kernel against the plain whole solve (times of both)."""
    import torch

    from sde4mbrl_px4_tpu_torch.learning import distill as TD
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.parallel.batched import make_batched_mpc

    reset_b, mpc_b, b = make_batched_mpc(TD._expert_cfg(cfg, dcfg), device=dev)
    xs, ts, xdes, ups = TD.sample_states(b, n, torch.Generator().manual_seed(5), dcfg)
    st = reset_b(xs, None, xdes)
    yk = st.yk.clone()
    yk[:, 0, :b.model.n_u] = ups
    st = st._replace(yk=yk)
    mpc_b(xs, None, st, ts, xdes)                        # warm
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n0 = AK.apg_solve_kernel.launches
    e0.record()
    sol = mpc_b(xs, None, st, ts, xdes)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    launches = AK.apg_solve_kernel.launches - n0
    iters = sol.opt_state.num_steps.float()
    apg = b.apg_config._replace(max_iter=10, max_no_improvement_iter=10)
    x_ref = TD._reference(b, ts[:1], xdes[:1])[0]
    args = (b.model, b.params, b.cost_params, apg, b.time_steps, xs[0], x_ref, ups[0], None, 1,
            b.lb, b.ub, yk[0])
    st_k, _ = AK.apg_solve_kernel(*args, precond=b.precond)
    st_p, _ = AK.apg_solve_plain(*args, precond=b.precond)
    if not (int(st_k.num_steps) == int(st_p.num_steps)
            and torch.allclose(st_k.yk, st_p.yk, rtol=2e-4, atol=2e-5)):
        raise AssertionError("a label scenario's fixed solve disagrees with plain")
    k_ms, p_ms = time_fixed(AK, args, b.precond, n_plain=1)
    return {"labels": n, "max_iter": b.apg_config.max_iter, "ms": ms, "launches": launches,
            "labels_per_s": n / ms * 1e3,
            "fixed10_du": float((st_k.yk - st_p.yk).abs().max()),
            "iterations_mean": float(iters.mean()), "iterations_max": int(iters.max()),
            "at_budget": float((iters >= b.apg_config.max_iter).float().mean()),
            "fixed10_ms": k_ms, "fixed10_plain_ms": p_ms, "bundle": b,
            "n_consts": n_consts(b, dev)}


def learning_distill(dev, td: str, card: str, argv: tuple = (), label_n: int = 4096,
                     label_iters: int = 300) -> dict:
    """(d) ``sim/policy_distill.py`` at the example's widths (its defaults:
    4096 states, 300-iteration labels, one DAgger round of 32 x 100, hidden
    256 256, 3000 steps): each label call one ``apg_solve`` launch (B = n,
    ``ceil(n / B)`` = 1), its first ``LABEL_SOLO`` scenarios bit-equal to their
    solo solves; the shoot-out's PASS; the distilled policy served through
    ``solver: policy`` (one ``value_batch`` and one ``trajectory`` a solve)
    and held to its plain version (``policy_pure_parity``)."""
    import torch

    from sde4mbrl_px4_tpu_torch.learning import distill as TD
    from sde4mbrl_px4_tpu_torch.sim import policy_distill

    calls = []
    orig, wrapped = label_wrapper(TD, calls)
    TD.label_states = wrapped
    try:
        zero_counts()
        res = policy_distill.run(["--outdir", td, *argv])
        torch.cuda.synchronize()
        got = counts()
    finally:
        TD.label_states = orig
    label_launches = sum(c["launches"] for c in calls)
    expect = {"apg_solve": label_launches + res["ticks"] + 1, "value_batch": res["ticks"] + 1,
              "value_and_grad": 0, "trajectory": res["ticks"] + 1}
    check_route("policy distillation (labels and shoot-out)", expect)
    for c in calls:
        c["bits"] = label_solo_bits(c, dev)
        log(f"phase 25d: label call {c['kind']} n={c['n']}: {c['launches']} apg_solve "
            f"launch(es) (ceil(n/B) = 1 at B = n), {c['s'] * 1e3:.1f} ms wall "
            f"({c['n'] / c['s']:.0f} labels/s); first {LABEL_SOLO} scenarios bit-equal to "
            f"their solo solves: {c['bits']}/{LABEL_SOLO}")
        if c["launches"] != 1 or c["bits"] != LABEL_SOLO:
            raise AssertionError(f"label call {c['kind']} n={c['n']} failed its checks")
    for kind, st in res["distill"].items():
        tr = [st["train_s"]] + [st[k] for k in st if k.startswith("dagger") and
                                k.endswith("train_s")]
        log(f"phase 25d: {kind} policy trained: {len(tr)} x {res['steps']} steps in "
            f"{', '.join(f'{s:.2f}' for s in tr)} s = "
            f"{', '.join(f'{res['steps'] / s:.0f}' for s in tr)} steps/s; loss "
            f"{st['losses'][0]:.5f} -> {st['losses'][1]:.5f}")
    log(f"phase 25d: shoot-out over {res['ticks']} ticks ({card}): APG {res['err_apg_m']:.4f} m "
        f"at {res['apg_ms']:.2f} ms a solve, policy {res['err_policy_m']:.4f} m at "
        f"{res['policy_ms']:.2f} ms (gate < {res['gate_m']:.3f} m) -> "
        f"{'PASS' if res['ok'] else 'FAIL'}; launches {got}")
    if not res["ok"]:
        raise AssertionError(f"sim/policy_distill.py failed its gate: {res}")
    served = distilled_served(dev, distilled_config(res["checkpoints"]["traj"]))
    # each label launch re-run for its device time, at the drive's widths
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    dcfg = TD.DistillConfig(expert_max_iter=label_iters)
    launch = {}
    for kind in ("traj", "posctrl"):
        cfg = load_yaml_config(os.path.join(ROOT, f"configs/iris_{kind}_mpc.yaml"))
        launch[kind] = label_launch(cfg, dcfg, dev, label_n)
        r = launch[kind]
        log(f"phase 25d: label launch {kind}, B={label_n} at {r['max_iter']} iterations ({card}): "
            f"{r['ms']:.3f} ms device ({r['launches']} launch), {r['labels_per_s']:.0f} "
            f"labels/s at {r['iterations_mean']:.1f} iterations a scenario (max "
            f"{r['iterations_max']}, {100 * r['at_budget']:.1f} % at the budget); one "
            f"scenario at 10 it.: kernel {r['fixed10_ms']:.4f} ms, plain "
            f"{r['fixed10_plain_ms']:.1f} ms")
    return {"drive": res, "calls": [{k: v for k, v in c.items()
                                     if k not in ("cfg", "dcfg", "solo", "labels")}
                                    for c in calls],
            "launches": got, "label_launches": {k: sum(c["launches"] for c in calls
                                                       if c["kind"] == k)
                                                for k in ("traj", "posctrl")},
            "served": served, "launch": launch}


def distilled_served(dev, cfg: dict, n: int = POLICY_REPLAY) -> dict:
    """The distilled policy served through ``solver: policy`` on the card:
    ``n`` chained pure-policy solves (one ``value_batch`` and one
    ``trajectory`` launch each), each held to the plain version: the
    network's plan against the CPU's from the same state and warm start
    (|du| <= 1e-5, phase 21's gate), the kernel's telemetry cost against the
    plain oracle's cost of the same plan (rtol 2e-5), ``x_evol`` against the
    mean rollout of the plan (rtol 1e-5 / atol 1e-6). The CPU solve's own
    cost (of its own plan) is printed beside it."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc, make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import cost_oracle_batched
    from sde4mbrl_px4_tpu_torch.ops.rollout import rollout_mean

    c, (reset_k, mpc_k), sft, b = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    _, (reset_p, mpc_p), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    _, bc, pc = build_mpc(copy.deepcopy(cfg), device="cpu")
    dt = float(c["_time_steps"][0])
    x, t0 = policy_start(sft, dev)
    st = reset_k(x, None, x)
    du = dc = dc_own = dx = 0.0
    zero_counts()
    for k in range(n):
        t = t0 + k * dt
        sol = mpc_k(x, None, st, t, x)
        st_cpu = type(st)(*(f.cpu() for f in st))
        one = mpc_p(x.cpu(), None, st_cpu, t, x.cpu())
        xc = x.cpu()[None]
        x_ref = pc.build_ref(torch.tensor([t], dtype=torch.float32), pc.targets(xc))
        orc = cost_oracle_batched(bc.model, bc.params, bc.cost_params, bc.time_steps, xc, x_ref,
                                  st_cpu.yk[None, 0], None, 1, bc.apg_config.maxls)
        with torch.no_grad():
            plain = float(orc.value(sol.u_opt.cpu()[None])[0])
        card = float(sol.opt_state.opt_cost)
        du = max(du, float((sol.u_opt.cpu() - one.u_opt).abs().max()))
        dc = max(dc, abs(card - plain) / abs(plain))
        dc_own = max(dc_own, abs(card - float(one.opt_state.opt_cost)) / abs(plain))
        ref = rollout_mean(b.model, b.params, x, sol.u_opt, b.time_steps)
        dx = max(dx, float((sol.x_evol - ref).abs().max()))
        if not (torch.allclose(sol.x_evol, ref, rtol=1e-5, atol=1e-6)
                and int(sol.opt_state.num_steps) == 0):
            raise AssertionError("the distilled policy: x_evol or stats differ")
        st, x = sol.opt_state, sol.x_evol[1]
    got = check_route("the distilled policy served", {
        "apg_solve": 0, "value_batch": n, "value_and_grad": 0, "trajectory": n})
    log(f"phase 25d: the distilled traj policy served ({n} chained solves), card against "
        f"plain: plan max|du| {du:.3e} (gate 1e-5), the kernel's cost against the plain cost "
        f"of the same plan rel {dc:.3e} (2e-5; against the CPU solve's own plan {dc_own:.3e}, "
        f"printed), x_evol max|dx| {dx:.3e} (rtol 1e-5 / atol 1e-6)")
    if not (du <= 1e-5 and dc <= 2e-5):
        raise AssertionError("the distilled policy disagrees with its plain version")
    return {"du": du, "cost_rel": dc, "cost_rel_own_plan": dc_own, "dx": dx, "launches": got}


def distilled_config(ckpt: str) -> dict:
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(ROOT, "configs/iris_traj_mpc.yaml"))
    cfg.update(solver="policy", policy={"params_path": ckpt})
    return cfg


def learning_fault7(dev, td: str) -> str:
    """(e) a 32-wide trunk: APG at P=1 is refused when the solver is built
    (the message names fault 7), with no launch; MPPI on it builds."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
    from sde4mbrl_px4_tpu_torch.models.params_io import save_params
    from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
    from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config

    ckpt = os.path.join(td, "iris_sde_h32.pkl")
    save_params(ckpt, init_params(torch.Generator().manual_seed(3),
                                  NeuralSDE.for_vehicle(iris_config()), hidden=32),
                {"vehicle": "iris", "hidden": 32})
    cfg = load_yaml_config(os.path.join(ROOT, "configs/iris_traj_mpc.yaml"))
    cfg["learned_model_params"] = ckpt
    zero_counts()
    try:
        make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("a 32-wide trunk was not refused at build")
    cfg["solver"] = "mppi"
    make_mpc_from_config(cfg, device=dev)
    log(f"phase 25e: a 32-wide trunk refused at build_mpc: {msg[:160]}...; MPPI on it builds; "
        f"launches {counts()}")
    if "fault 7" not in msg or any(counts().values()):
        raise AssertionError(f"the fault-7 refusal is wrong: {msg}")
    return msg


def phase_learning(dev, card: str) -> dict:
    """Phase 25, the learning loop on the card (module docstring)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_learning_") as td:
        flight = learning_log(td, card)
        train = learning_train(dev, td, flight["npz"], card)
        probe = learning_probe(dev, train["ckpt"], card)
        distill = learning_distill(dev, td, card)
        fault7 = learning_fault7(dev, td)
    return {"log": flight, "train": train, "probe": probe, "distill": distill,
            "fault7": fault7}


# ---------------------------------------------------------------- phase 26
# the tuning sweeps at tools/tune_mppi.py's default grid (:33-35) and a
# 27-row weight grid, 40 periods each; the candidates held bit for bit to
# their solo solves at two periods; the mismatch sweep; the geometric node
TUNE_CONFIGS = ("iris_posctrl_mpc", "iris_traj_mpc")
TUNE_STEPS = 40
TUNE_SIGMAS, TUNE_TEMPS, TUNE_BETAS = [0.01, 0.02, 0.04], [0.05, 0.1, 0.2], [0.0, 0.5, 0.7]
WEIGHT_SCALES = ([0.5, 1.0, 2.0], [0.5, 1.0, 2.0], [0.5, 1.0, 2.0], [1.0])
TUNE_EFFORT = 0.05
TUNE_CHECK = (0, 9, 13, 26)           # candidates held to their solo solves
TUNE_PERIODS = (0, TUNE_STEPS // 2)   # ... at these periods
TUNE_PLAIN_ITERS = 10                 # the weight sweep's plain comparison budget
GEO_NODE_S = 2.0                      # the geometric launch node's run
GEO_SIM_S = 6.0                       # examples/geometric_baseline_sim.py's --seconds


@contextlib.contextmanager
def recorded_sweeps(periods: tuple = TUNE_PERIODS):
    """Record a tuner's builds and, at ``periods``, its batched solves'
    inputs, draws and solutions (``tuning/tuner.py`` calls ``build_mpc``
    twice: the probe, then the candidates' solver). ``rec["t0"]`` and
    ``rec["e0"]`` mark the first solve's dispatch (host clock, CUDA
    event)."""
    import torch

    from sde4mbrl_px4_tpu_torch.solver.apg import APGState
    from sde4mbrl_px4_tpu_torch.tuning import tuner

    rec = {"builds": [], "calls": {}}
    orig = tuner.build_mpc

    def build(*a, **kw):
        cfg, bundle, pieces = orig(*a, **kw)
        rec["builds"].append((cfg, bundle, pieces))
        solve, k = pieces.solve, [0]

        def recording(xs, rngs, st, ts, xdes=None, iter_budget=None):
            i = k[0]
            k[0] += 1
            if i == 0:
                rec["t0"] = time.perf_counter()
                rec["e0"] = torch.cuda.Event(enable_timing=True)
                rec["e0"].record()
            if i not in periods:
                return solve(xs, rngs, st, ts, xdes, iter_budget)
            item = None
            if rngs is not None and not isinstance(rngs, torch.Generator):
                item = next(rngs)
                rngs = iter([item])
            inp = (xs.clone(), APGState(*(f.clone() for f in st)), ts.clone(), xdes.clone(),
                   item)
            sol = solve(xs, rngs, st, ts, xdes, iter_budget)
            rec["calls"][i] = (inp, sol)
            return sol

        return cfg, bundle, pieces._replace(solve=recording)

    tuner.build_mpc = build
    try:
        yield rec
    finally:
        tuner.build_mpc = orig


@contextlib.contextmanager
def plain_batched():
    """The loader's batched kernel wrappers swapped for their plain versions
    on the same device (parity only)."""
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    orig = (mpc_loader.apg_solve_kernel_batched, mpc_loader.cost_oracle_batched)
    mpc_loader.apg_solve_kernel_batched = AK.apg_solve_plain_batched
    mpc_loader.cost_oracle_batched = CO.cost_oracle_plain_batched
    try:
        yield
    finally:
        mpc_loader.apg_solve_kernel_batched, mpc_loader.cost_oracle_batched = orig


def timed_sweep(fn, cfg: dict, grid, steps: int, **kw) -> tuple:
    """One sweep, recorded: ``(results, rec, stats)``, stats the ms a
    period (host, from the first solve's dispatch to the scores on the
    host; device, CUDA events), closed-loop solves/s and the launches a
    period per kernel (zeroed just before)."""
    import torch

    with recorded_sweeps() as rec:
        zero_counts()
        res = fn(copy.deepcopy(cfg), grid, steps=steps, **kw)
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - rec["t0"]
    got = counts()
    N = len(grid)
    stats = {"ms_per_period": 1e3 * wall / steps,
             "device_ms_per_period": rec["e0"].elapsed_time(e1) / steps,
             "solves_per_s": N * steps / wall, "candidates": N, "steps": steps,
             "launches": got, "launches_per_period": {k: v / steps for k, v in got.items()}}
    return res, rec, stats


def tuner_solo_bits(tag: str, kind: str, cfg: dict, rec: dict, grid, dev) -> int:
    """Candidates ``TUNE_CHECK`` of each recorded batched solve against their
    solo ``mpc_fn`` on the card, built with their own knobs (Python
    floats) or tracking weights, on the recorded inputs and draws: bit for
    bit (``bit_equal_to_solo``)."""
    from sde4mbrl_px4_tpu_torch.core.types import MPCSolution
    from sde4mbrl_px4_tpu_torch.cost.cost import scenario_cost
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.solver.apg import APGState
    from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig

    probe, cand = rec["builds"][0][1], rec["builds"][1][1]
    fns = {}
    for i in TUNE_CHECK:
        if kind == "mppi":
            s = MPPIConfig.from_config(cfg)
            kw = {"mppi_params": MPPIConfig(samples=s.samples, sigma=float(grid[i, 0]),
                                            temperature=float(grid[i, 1]), iters=s.iters,
                                            noise_beta=float(grid[i, 2]))}
        else:
            kw = {"cost_params_override": scenario_cost(cand.cost_params, i)}
        fns[i] = make_mpc_from_config(copy.deepcopy(cfg), device=dev,
                                      state_from_traj=probe.state_from_traj, **kw)[1][1]
    idx = list(TUNE_CHECK)
    n = 0
    for period, ((xs, st, ts, xdes, item), sol) in sorted(rec["calls"].items()):
        solos = [fns[i](xs[i], None if item is None else iter([(item[0][i], item[1][i])]),
                        scenario_state(st, i), ts[i], xdes[i]) for i in idx]
        sub = MPCSolution(u_opt=sol.u_opt[idx], rng=None, x_evol=sol.x_evol[idx],
                          opt_state=APGState(*(f[idx] for f in sol.opt_state)))
        n += bit_equal_to_solo(f"{tag}, period {period}, candidates {idx}", sub, solos)
    return n


def tuning_mppi(dev, name: str, card: str) -> dict:
    """``tune_mppi`` on ``name`` at the tool's default grid (27 candidates,
    K = 64, 8 rounds) over ``TUNE_STEPS`` periods: the table, the times,
    the launches a period (``iters + 2`` ``value_batch`` over 27 x 64
    plans and one ``trajectory`` over 27 plans), four candidates bit-equal
    to their solo solves at two periods; then one period against the plain
    oracle on the same draws (scores rtol 1e-5, plans |du| <= 1e-4, phase
    7's gate); the per-launch times of both kernels at the sweep's shapes."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig
    from sde4mbrl_px4_tpu_torch.tuning import make_mppi_grid, tune_mppi

    cfg = config(name, solver="mppi")
    static = MPPIConfig.from_config(cfg)
    grid = make_mppi_grid(TUNE_SIGMAS, TUNE_TEMPS, TUNE_BETAS)
    N, it = len(grid), static.iters
    res, rec, st = timed_sweep(tune_mppi, cfg, grid, TUNE_STEPS)
    want = {"apg_solve": 0, "value_batch": TUNE_STEPS * (it + 2), "value_and_grad": 0,
            "trajectory": TUNE_STEPS}
    check_route(f"tune_mppi {name}", want)
    log(f"tune_mppi {name} ({card}): {N} candidates x {TUNE_STEPS} periods (K={static.samples}, "
        f"{it} rounds): {st['ms_per_period']:.3f} ms a period host, "
        f"{st['device_ms_per_period']:.3f} device; {st['solves_per_s']:.0f} closed-loop "
        f"solves/s; launches a period {st['launches_per_period']}")
    for r in res[:5]:
        log(f"  sigma {r.sigma:.4g} temp {r.temperature:.4g} beta {r.noise_beta:.3g}: mean "
            f"{r.mean_pos_err:.4f} m final {r.final_pos_err:.4f} m")
    log("  best as a config block: " + res[0].yaml_block(static.samples, it).replace("\n", "; "))
    if not all(math.isfinite(r.mean_pos_err) for r in res):
        raise AssertionError(f"tune_mppi {name}: a non-finite score")
    st["bit_equal"] = tuner_solo_bits(f"tune_mppi {name}", "mppi", cfg, rec, grid, dev)
    # one period, kernels against the plain oracle on the same draws
    with recorded_sweeps((0,)) as rk:
        one_k = tune_mppi(copy.deepcopy(cfg), grid, steps=1)
    t = time.perf_counter()
    with plain_batched(), recorded_sweeps((0,)) as rp:
        one_p = tune_mppi(copy.deepcopy(cfg), grid, steps=1)
    st["plain_period_s"] = time.perf_counter() - t
    key = lambda r: (r.sigma, r.temperature, r.noise_beta)
    pk, pp = ({key(r): r.mean_pos_err for r in rows} for rows in (one_k, one_p))
    rel = max(abs(pk[k] - pp[k]) / abs(pp[k]) for k in pp)
    du = float((rk["calls"][0][1].u_opt - rp["calls"][0][1].u_opt).abs().max())
    st.update(first_period_rel=rel, first_period_du=du)
    log(f"tune_mppi {name}, one period, kernels vs plain ({N} candidates, same draws): scores "
        f"rel {rel:.3e} (1e-5), plans max|du| {du:.3e} (1e-4); plain {st['plain_period_s']:.2f} s")
    if rel > 1e-5 or du > 1e-4:
        raise AssertionError(f"tune_mppi {name}: the kernels disagree with the plain oracle")
    # the kernels at the sweep's shapes, per launch
    (xs, s0, ts, xdes, item), sol = rec["calls"][0]
    cfg_b, b, pieces = rec["builds"][1]
    x_ref = pieces.build_ref(ts, pieces.targets(xdes))
    ob = CO.cost_oracle_batched(b.model, b.params, b.cost_params, b.time_steps, xs, x_ref,
                                s0.yk[:, 0], None, 1, 4)
    H, nZ = int(b.time_steps.shape[0]), int(b.lb_z.shape[0])
    U = (s0.yk[:, None] + 0.05 * torch.randn((N, static.samples, H, nZ),
                                             generator=torch.Generator().manual_seed(5)
                                             ).to(dev)).clamp(b.lb_z, b.ub_z).contiguous()
    plain = [CO.cost_oracle_plain(b.model, b.params, b.cost_params, b.time_steps, xs[i],
                                  x_ref[i], s0.yk[i, 0], None, 1, 4) for i in (0, N - 1)]
    costs, traj = ob.value_batch(U), ob.trajectory(sol.u_opt.contiguous())
    vb_err = max(float(((costs[i] - p.value_batch(U[i])).abs() / costs[i].abs()).max())
                 for i, p in zip((0, N - 1), plain))
    tr_err = max(float((traj[i] - p.trajectory(sol.u_opt[i])).abs().max())
                 for i, p in zip((0, N - 1), plain))
    st.update(value_batch_ms=per_launch_ms(lambda: ob.value_batch(U), 20),
              trajectory_ms=per_launch_ms(lambda: ob.trajectory(sol.u_opt.contiguous()), 20),
              value_batch_plain_ms=per_launch_ms(lambda: plain[0].value_batch(U[0]), 3),
              trajectory_plain_ms=per_launch_ms(lambda: plain[0].trajectory(sol.u_opt[0]), 3),
              value_batch_err=vb_err, trajectory_err=tr_err, bundle=b,
              n_consts=n_consts(b, dev), K=static.samples,
              table=[r._asdict() for r in res[:5]])
    log(f"tune_mppi {name}: value_batch over {N} x {static.samples} plans "
        f"{st['value_batch_ms']:.4f} ms a launch (plain one scenario "
        f"{st['value_batch_plain_ms']:.2f} ms; rel {vb_err:.2e}), trajectory over {N} plans {st['trajectory_ms']:.4f} ms (plain "
        f"one plan {st['trajectory_plain_ms']:.2f} ms; max|dx| {tr_err:.2e})")
    if vb_err > 2e-5 or tr_err > 1e-4:
        raise AssertionError(f"tune_mppi {name}: a kernel disagrees with the plain oracle")
    return st


def tuning_weights(dev, name: str, card: str) -> dict:
    """``tune_cost_weights`` on ``name``: a 27-row grid over ``TUNE_STEPS``
    periods, noisy plant, ``effort_weight`` ``TUNE_EFFORT``: one launch of
    the whole-solve kernel over the 27 candidates a period, each with its
    own tracking weights; four candidates bit-equal to their solo solves
    with their weights at two periods; the four at a ``TUNE_PLAIN_ITERS``
    budget against the plain whole solve, one period (scores and plans
    rtol 2e-4 / atol 2e-5, equal steps); the launch over 27 timed."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.cost.cost import scenario_cost
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.tuning import make_weight_grid, tune_cost_weights

    cfg = config(name)
    grid = make_weight_grid(*WEIGHT_SCALES)
    N = len(grid)
    res, rec, st = timed_sweep(tune_cost_weights, cfg, grid, TUNE_STEPS,
                               effort_weight=TUNE_EFFORT)
    check_route(f"tune_cost_weights {name}", {"apg_solve": TUNE_STEPS, "value_batch": 0,
                                              "value_and_grad": 0, "trajectory": 0})
    sol0 = rec["calls"][0][1]
    steps = sol0.opt_state.num_steps
    log(f"tune_cost_weights {name} ({card}): {N} candidates x {TUNE_STEPS} periods "
        f"({cfg['apg_mpc']['max_iter']}-iteration budget, first period {float(steps.mean()):.1f}"
        f" it. mean, {float(steps.max()):.0f} max): {st['ms_per_period']:.3f} ms a period host,"
        f" {st['device_ms_per_period']:.3f} device; {st['solves_per_s']:.0f} closed-loop "
        f"solves/s; launches a period {st['launches_per_period']}")
    for r in res[:5]:
        log(f"  p {r.p_scale:g} v {r.v_scale:g} q {r.q_scale:g} w {r.w_scale:g}: score "
            f"{r.score:.4f} (err {r.mean_pos_err:.4f} m, effort {r.effort:.5f})")
    if not all(math.isfinite(r.score) for r in res):
        raise AssertionError(f"tune_cost_weights {name}: a non-finite score")
    st["bit_equal"] = tuner_solo_bits(f"tune_cost_weights {name}", "weights", cfg, rec, grid,
                                      dev)
    # the launch over the 27 candidates at the sweep's first period, timed
    (xs, s0, ts, xdes, _), _ = rec["calls"][0]
    _, b, pieces = rec["builds"][1]
    x_ref = pieces.build_ref(ts, pieces.targets(xdes))
    launch = lambda: AK.apg_solve_kernel_batched(
        b.model, b.params, b.cost_params, b.apg_config, b.time_steps, xs, x_ref, s0.yk[:, 0],
        None, 1, b.lb_z, b.ub_z, s0.yk, t_init=s0.stepsize if pieces.carry_t else None,
        precond=b.precond)
    st["launch_ms"] = per_launch_ms(launch, 5)
    st["iterations_mean"] = float(steps.mean())
    # four candidates at a fixed budget, kernel against plain, one period
    sub = grid[list(TUNE_CHECK)]
    small = copy.deepcopy(cfg)
    small["apg_mpc"]["max_iter"] = TUNE_PLAIN_ITERS
    with recorded_sweeps((0,)) as rk:
        one_k = tune_cost_weights(copy.deepcopy(small), sub, steps=1,
                                  effort_weight=TUNE_EFFORT)
    with plain_batched(), recorded_sweeps((0,)) as rp:
        one_p = tune_cost_weights(copy.deepcopy(small), sub, steps=1,
                                  effort_weight=TUNE_EFFORT)
    sk, sp = rk["calls"][0][1], rp["calls"][0][1]
    # one scenario's plain solve at that budget, timed
    bk = rk["builds"][1][1]
    apg10 = bk.apg_config
    t = time.perf_counter()
    AK.apg_solve_plain(bk.model, bk.params, scenario_cost(bk.cost_params, 0), apg10,
                       bk.time_steps, xs[0], x_ref[0], s0.yk[0, 0], None, 1, bk.lb_z, bk.ub_z,
                       s0.yk[0], t_init=s0.stepsize[0] if pieces.carry_t else None,
                       precond=bk.precond)
    torch.cuda.synchronize()
    st["plain_ms"] = 1e3 * (time.perf_counter() - t)
    key = lambda r: (r.p_scale, r.v_scale, r.q_scale, r.w_scale)
    pk = {key(r): (r.score, r.effort) for r in one_k}
    bad = [k for k, r in ((key(r), r) for r in one_p)
           if not np.allclose(pk[k], (r.score, r.effort), rtol=2e-4, atol=2e-5)]
    du = float((sk.u_opt - sp.u_opt).abs().max())
    same_steps = bool((sk.opt_state.num_steps == sp.opt_state.num_steps).all())
    plans_ok = bool(np.allclose(sk.u_opt.cpu().numpy(), sp.u_opt.cpu().numpy(), rtol=2e-4,
                                atol=2e-5))
    st.update(fixed_du=du, bundle=b, n_consts=n_consts(b, dev),
              table=[r._asdict() for r in res[:5]])
    log(f"tune_cost_weights {name}, candidates {list(TUNE_CHECK)} at {TUNE_PLAIN_ITERS} "
        f"iterations, one period, kernel vs plain: scores {'within' if not bad else 'OUTSIDE'} "
        f"rtol 2e-4 / atol 2e-5, plans max|du| {du:.3e} ({'within' if plans_ok else 'OUTSIDE'}"
        f"), equal steps {same_steps}; the launch over {N} at the full budget "
        f"{st['launch_ms']:.3f} ms, one scenario's plain solve at {TUNE_PLAIN_ITERS} it. "
        f"{st['plain_ms']:.1f} ms")
    if bad or not (plans_ok and same_steps):
        raise AssertionError(f"tune_cost_weights {name}: the kernel disagrees with plain: {bad}")
    return st


def tuning_mismatch(card: str) -> dict:
    """The iris mismatch sweep in full (``sim/mismatch_sweep.py``: 11 cells,
    4 s, 60 iterations, the MPC, the MPC with the offset estimator and the
    native geometric controller), its JSON to a temporary directory; gate:
    its PASS with the geometric controller flown, and one ``apg_solve``
    launch per MPC period."""
    import torch

    from sde4mbrl_px4_tpu_torch.sim import mismatch_sweep

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mismatch_") as td:
        zero_counts()
        t = time.perf_counter()
        rec = mismatch_sweep.run(["--out", os.path.join(td, "MISMATCH.json")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    got = counts()
    check_route("mismatch sweep", {"apg_solve": rec["mpc_periods"], "value_batch": 0,
                                   "value_and_grad": 0, "trajectory": 0})
    log(f"mismatch sweep (iris, {card}): {len(rec['cells'])} cells in {wall:.1f} s, gate "
        f"{'PASS' if rec['gate']['pass'] else 'FAIL'}, geometric flown {rec['geometric']}")
    if not (rec["gate"]["pass"] and rec["geometric"]
            and all("geo_mean_m" in r for r in rec["cells"])):
        raise AssertionError(f"the mismatch sweep failed (or flew without the native "
                             f"controller): {rec}")
    return {"wall_s": wall, "launches": got, "cells": rec["cells"], "gate": rec["gate"]}


def tuning_geometric_node(card: str) -> dict:
    """The launch tier's geometric node: ``iris_geoctrl.yaml`` as one
    ``python -m sde4mbrl_px4_tpu_torch.launch`` process, then ``fcu_sim``
    (iris) on the same port, so the node flies the plant from its first
    state (the trajectory's start, where the node's clock starts); after
    ``GEO_NODE_S`` of both serving, SIGTERM to each. Gates: both READY,
    the node answers the FCU's states (its count of MPC_MOTORS_CMD frames),
    the FCU reports ``MPC_ON``, both exit 0; the FCU's positions are
    printed."""
    import queue
    import threading

    import yaml

    d = os.path.join(ROOT, "build", "chip_smoke", "geometric")
    os.makedirs(d, exist_ok=True)
    mav = free_udp_port()
    files = {}
    for key, name in (("fcu_sim", "iris_px4_sitl.yaml"), ("geometric", "iris_geoctrl.yaml")):
        with open(os.path.join(ROOT, "configs", "launch", name)) as f:
            cfg = yaml.safe_load(f)
        cfg["addr_mavlink_state_msg"] = f"127.0.0.1:{mav}"
        if key == "fcu_sim":
            cfg["config_dir"] = os.path.join(ROOT, "configs")
        else:
            cfg["trajectory_path"] = os.path.join(ROOT, "configs", cfg["trajectory_path"])
        files[key] = os.path.join(d, name)
        with open(files[key], "w") as f:
            yaml.safe_dump(cfg, f)
    procs, logs = {}, {k: [] for k in files}
    ready: "queue.Queue" = queue.Queue()

    def pump(key, proc):
        for line in proc.stdout:
            logs[key].append(line.rstrip())
            if "[launch] READY" in line:
                ready.put(key)

    out = {}
    try:
        for key in ("geometric", "fcu_sim"):
            procs[key] = subprocess.Popen(
                [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", files[key]], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1)
            threading.Thread(target=pump, args=(key, procs[key]), daemon=True).start()
            try:
                if ready.get(timeout=LAUNCH_READY_S) != key:
                    raise queue.Empty
            except queue.Empty:
                raise AssertionError(f"{key} did not become READY: {logs[key][-10:]}")
        time.sleep(GEO_NODE_S)
        n_reports = len(logs["fcu_sim"])
    finally:
        for key in ("geometric", "fcu_sim"):
            if key in procs and procs[key].poll() is None:
                procs[key].terminate()
                try:
                    procs[key].wait(timeout=30)
                except subprocess.TimeoutExpired:
                    procs[key].kill()
            if key in procs:
                out[f"{key}_rc"] = procs[key].wait(timeout=30)
    m = re.search(r"sent (\d+) MPC_MOTORS_CMD", "\n".join(logs["geometric"]))
    out["commands"] = int(m.group(1)) if m else 0
    reports = [ln for ln in logs["fcu_sim"][:n_reports] if ln.startswith("[fcu_sim]")]
    out["mpc_on_reports"] = sum("status=1" in ln for ln in reports)
    out["fcu_tail"] = reports[-3:]
    log(f"geometric launch node ({card}): {out['commands']} MPC_MOTORS_CMD frames over "
        f"{GEO_NODE_S} s of fcu_sim streaming; fcu_sim reports MPC_ON {out['mpc_on_reports']} "
        f"times; exit codes on SIGTERM: node {out['geometric_rc']}, fcu_sim "
        f"{out['fcu_sim_rc']}; {out['fcu_tail']}")
    if not (out["geometric_rc"] == 0 and out["fcu_sim_rc"] == 0 and out["commands"] >= 50
            and out["mpc_on_reports"] >= 1):
        raise AssertionError(f"the geometric launch node did not serve: {out}; "
                             f"{logs['geometric'][-5:]}")
    return out


def phase_tuning(dev, card: str) -> dict:
    """Phase 26, batched tuning, the mismatch sweep and the geometric node
    (module docstring)."""
    out = {"mppi": {}, "weights": {}}
    for name in TUNE_CONFIGS:
        out["mppi"][name] = tuning_mppi(dev, name, card)
        out["weights"][name] = tuning_weights(dev, name, card)
    out["mismatch"] = tuning_mismatch(card)
    out["geometric"] = tuning_geometric_node(card)
    out["geometric_sim"] = tuning_geometric_sim()
    return out


def tuning_geometric_sim() -> dict:
    """``sim/geometric_baseline.py`` at the example's 6 s: the native
    controller following the circle over UDP against the FCU shim (on the
    host; the node's tracking, which the launch check does not gate);
    gate: its PASS."""
    from sde4mbrl_px4_tpu_torch.sim import geometric_baseline

    res = geometric_baseline.run(["--seconds", str(GEO_SIM_S)])
    log(f"geometric baseline flight ({GEO_SIM_S} s): mean {res['err_mean_m']:.4f} m, max "
        f"{res['err_max_m']:.4f} m over {res['ticks']} ticks, FCU status {res['fcu_status']} "
        f"-> {'PASS' if res['ok'] else 'FAIL'}")
    if not res["ok"]:
        raise AssertionError(f"the geometric baseline flight failed: {res}")
    return res



# ---------------------------------------------------------------- phase 27
# the SITL deployment stack: the router (both implementations and its
# bench), the full stack with the engine node on the card and the live tap,
# the router launch node and the mission REPL, and the port's preflight
SITL_BURST = 300                      # frames of the router topology's paced burst
SITL_STACK_S = 8.0                    # sim/full_sitl_stack.py's --seconds (its default)
SITL_STACK_WALL_S = 600.0             # its subprocess's time limit
SITL_TAP = ("127.0.0.1", 14996)       # configs/router_sitl.conf's liveview endpoint
SITL_REPL = "controller_init\ncontroller_idle\nweight_motors 100\ncontroller_off\nexit\n"


def sitl_router_topology(kind: str) -> dict:
    """The router test topology on free ports: an FCU server endpoint, an
    unfiltered sink and an MPC sink with ``AllowMsgIdOut 367`` /
    ``AllowMsgIdIn 368``. A paced burst of states (367) and commands (368)
    from the FCU; every few frames the MPC sink answers with a 368 and
    spoofs a 367. Gates: the unfiltered sink gets every FCU frame and every
    reply, the MPC sink exactly the FCU's 367s, the FCU every reply and no
    spoofed 367."""
    import collections
    import socket

    import numpy as np

    from sde4mbrl_px4_tpu_torch.io import mavlink as mav
    from sde4mbrl_px4_tpu_torch.io.router import Endpoint, NativeRouter, Router

    socks = {k: socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for k in ("fcu", "plain", "mpc")}
    for s in socks.values():
        s.bind(("127.0.0.1", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        s.setblocking(False)
    eps = [Endpoint("fcu", "127.0.0.1", 0, mode="Server"),
           Endpoint("plain", "127.0.0.1", socks["plain"].getsockname()[1]),
           Endpoint("mpc", "127.0.0.1", socks["mpc"].getsockname()[1],
                    allow_out={367}, allow_in={368})]
    impl = NativeRouter if kind == "native" else Router
    r = impl(eps)
    r.start()
    want = {k: collections.Counter() for k in socks}
    got = {k: collections.Counter() for k in socks}
    rs = np.random.RandomState(27)
    try:
        ports = ({n: r.bound_port(n) for n in ("fcu", "mpc")} if impl is NativeRouter
                 else {"fcu": eps[0].bound_port, "mpc": eps[2].bound_port})
        for k in range(SITL_BURST):
            fr = bytes(mav.encode_full_state(k, rs.randn(13).astype(np.float32), seq=k) if k % 3
                       else mav.encode_motors_cmd(k, rs.rand(6), rs.rand(4), 3, 100, seq=k))
            socks["fcu"].sendto(fr, ("127.0.0.1", ports["fcu"]))
            want["plain"][fr] += 1
            if k % 3:
                want["mpc"][fr] += 1
            if k % 10 == 9:
                reply = bytes(mav.encode_motors_cmd(10_000 + k, rs.rand(6), rs.rand(4), 3, 100))
                spoof = bytes(mav.encode_full_state(20_000 + k, np.zeros(13, np.float32)))
                socks["mpc"].sendto(reply, ("127.0.0.1", ports["mpc"]))
                socks["mpc"].sendto(spoof, ("127.0.0.1", ports["mpc"]))
                want["plain"][reply] += 1
                want["fcu"][reply] += 1
            time.sleep(0.0005)
        deadline = time.perf_counter() + 1.0
        while time.perf_counter() < deadline:
            for key, s in socks.items():
                try:
                    got[key][s.recvfrom(512)[0]] += 1
                    deadline = time.perf_counter() + 0.3
                except BlockingIOError:
                    pass
        stats = dict(r.stats)
    finally:
        r.stop()
        for s in socks.values():
            s.close()
    out = {k: sum(got[k].values()) for k in socks}
    out["stats"] = stats
    ok = all(got[k] == want[k] for k in socks)
    log(f"router topology ({kind}): a paced burst of {SITL_BURST} FCU frames and "
        f"{SITL_BURST // 10} MPC replies (+ as many spoofed 367s): unfiltered sink "
        f"{out['plain']}/{sum(want['plain'].values())}, MPC sink {out['mpc']}/"
        f"{sum(want['mpc'].values())} (367 only), FCU {out['fcu']}/{sum(want['fcu'].values())} "
        f"(368 replies only); frames in per endpoint {stats} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {kind} router lost, leaked or misrouted frames: {out}")
    return out


def sitl_router(card: str) -> dict:
    """(a) Both router implementations on the test topology, then
    ``sim/bench_router.py`` at its default (20,000 frames each)."""
    from sde4mbrl_px4_tpu_torch.io.mavlink import load_native
    from sde4mbrl_px4_tpu_torch.sim import bench_router

    lib = load_native()
    if lib is None or not hasattr(lib, "router_new"):
        raise AssertionError("csrc/libmpc_native.so has no router core (phase 2 builds it)")
    out = {kind: sitl_router_topology(kind) for kind in ("python", "native")}
    bench = bench_router.run([])
    out["bench"] = bench
    log(f"router bench ({card} host, {bench['python']['frames']} frames each): python "
        f"{bench['python']['frames_per_s']:.0f} frames/s (loss {bench['python']['loss']:.3f}), "
        f"native {bench['native']['frames_per_s']:.0f} frames/s (loss "
        f"{bench['native']['loss']:.3f}); native/python {bench['native_over_python']:.3f}")
    return out


def sitl_stack(card: str) -> dict:
    """(b) ``sim/full_sitl_stack.py --seconds 8`` as a subprocess, the
    engine node on the card, while a socket bound at the conf's liveview
    address feeds the port's ``LiveMonitor``. Gates: ``RESULT: PASS``, the
    native router, the engine in the traj or pos mode with iterations, the
    tap fed both message ids, the engine's process launching the whole-solve
    kernel and no other."""
    import socket
    import threading

    from sde4mbrl_px4_tpu_torch.io.mavlink import decode_frame
    from sde4mbrl_px4_tpu_torch.sim.analyze import LiveMonitor

    tap = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tap.bind(SITL_TAP)
    tap.settimeout(0.2)
    mon = LiveMonitor(window_s=1e9, max_len=1 << 20)
    seen = {"MPC_FULL_STATE": [], "MPC_MOTORS_CMD": []}
    stop = threading.Event()

    def read_tap():
        while not stop.is_set():
            try:
                msg = decode_frame(tap.recv(512))
            except socket.timeout:
                continue
            if msg is None:
                continue
            seen[msg.get_type()].append(time.perf_counter())
            if msg.get_type() == "MPC_FULL_STATE":
                mon.ingest_state(msg.time_usec, msg.state, msg.motors)
            else:
                mon.ingest_cmd(msg.time_usec, msg.motor_val_des, msg.thrust_and_angrate_des)

    th = threading.Thread(target=read_tap, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.sim.full_sitl_stack",
                            "--seconds", str(SITL_STACK_S)], cwd=ROOT, capture_output=True,
                           text=True, timeout=SITL_STACK_WALL_S)
    finally:
        stop.set()
        th.join(timeout=5)
        tap.close()
    wall = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    res = json.loads(next((ln for ln in reversed(lines) if ln.startswith("{")), "{}") or "{}")
    passed = "RESULT: PASS" in lines
    router_line = next((ln for ln in lines if ln.startswith("== router")), "")
    rates = {}
    for kind, ts in seen.items():
        span = (ts[-1] - ts[0]) if len(ts) > 1 else 0.0
        rates[kind] = len(ts) / span if span else 0.0
    launches = res.get("engine_launches", {})
    out = {"rc": r.returncode, "wall_s": wall, "router_line": router_line,
           "tap_states": len(seen["MPC_FULL_STATE"]), "tap_commands": len(seen["MPC_MOTORS_CMD"]),
           "tap_states_per_s": rates["MPC_FULL_STATE"],
           "tap_commands_per_s": rates["MPC_MOTORS_CMD"], "tap_summary": mon.summary(),
           **{k: v for k, v in res.items() if k != "ok"}}
    log(f"full SITL stack ({card}; {router_line.strip('= ')}; engine READY in "
        f"{res.get('ready_s', float('nan')):.1f} s): station keeping over {res.get('ticks')} "
        f"ticks mean {res.get('err_mean_m', float('nan')):.4f} m max "
        f"{res.get('err_max_m', float('nan')):.4f} m; MPC_ON "
        f"{res.get('engage_s', float('nan')):.2f} s after ctrl_pos_current; engine state "
        f"{res.get('engine_state')}, {res.get('engine_num_steps')} iterations, solve "
        f"{res.get('engine_solve_ms', float('nan')):.3f} ms, pickup idx "
        f"{res.get('engine_mpc_indx')}; {res.get('engine_plans')} plans, the engine "
        f"process's launches {launches}; router frames in {res.get('router_stats')}; tap "
        f"{out['tap_states']} states ({out['tap_states_per_s']:.1f}/s) and "
        f"{out['tap_commands']} commands ({out['tap_commands_per_s']:.1f}/s), "
        f"{out['tap_summary']}; rc {r.returncode} in {wall:.1f} s wall -> "
        f"{'PASS' if passed else 'FAIL'}")
    if not (r.returncode == 0 and passed and "native C++" in router_line
            and res.get("engine_state") in ("traj", "pos")
            and (res.get("engine_num_steps") or 0) > 0
            and out["tap_states"] > 0 and out["tap_commands"] > 0
            and launches.get("apg_solve", 0) >= 1
            and not any(launches.get(k) for k in ("value_batch", "value_and_grad",
                                                  "trajectory"))):
        raise AssertionError(f"the full SITL stack failed: {out}\n" + "\n".join(lines[-40:])
                             + r.stderr[-3000:])
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    return out


def sitl_launch(card: str) -> dict:
    """(c) The launch tier: ``node: router`` on ``router_sitl.yaml`` with its
    conf rewritten to free ports (READY, a frame forwarded to the telemetry
    sink, rc 0 on SIGTERM), and ``iris_sdectrl.yaml --repl`` on free ports
    with a script on stdin (READY, the mission's load line, no ``error:``
    line, rc 0)."""
    import socket

    import numpy as np
    import yaml

    from sde4mbrl_px4_tpu_torch.io.mavlink import encode_full_state

    d = os.path.join(ROOT, "build", "chip_smoke", "sitl")
    os.makedirs(os.path.join(d, "launch"), exist_ok=True)
    with open(os.path.join(ROOT, "configs", "router_sitl.conf")) as f:
        conf = f.read()
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.settimeout(10.0)
    fcu = free_udp_port()
    conf = conf.replace("Port = 14550", f"Port = {fcu}").replace(
        "Port = 14999", f"Port = {sink.getsockname()[1]}")
    for port in (14998, 14996):
        conf = conf.replace(f"Port = {port}", f"Port = {free_udp_port()}")
    with open(os.path.join(d, "router.conf"), "w") as f:
        f.write(conf)
    with open(os.path.join(ROOT, "configs", "launch", "router_sitl.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["conf"] = "../router.conf"
    router_yaml = os.path.join(d, "launch", "router_sitl.yaml")
    with open(router_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    out = {}
    proc = subprocess.Popen([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch",
                             router_yaml], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "[launch] READY" in line:
                break
        frame = bytes(encode_full_state(27, np.eye(1, 13, 6, dtype=np.float32)[0]))
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as client:
            client.sendto(frame, ("127.0.0.1", fcu))
            out["router_forwarded"] = sink.recvfrom(512)[0] == frame
        time.sleep(1.2)                      # one stats report
    finally:
        sink.close()
        if proc.poll() is None:
            proc.terminate()
        try:
            out["router_rc"] = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out["router_rc"] = proc.wait(timeout=30)
    lines += [ln.rstrip() for ln in proc.stdout]
    out["router_line"] = next((ln for ln in lines if "fanning out" in ln), "")
    log(f"router launch node: {out['router_line']}; READY "
        f"{any('[launch] READY' in ln for ln in lines)}, frame forwarded "
        f"{out.get('router_forwarded')}, rc {out['router_rc']} on SIGTERM; "
        f"{[ln for ln in lines if ln.startswith('[router]')][-1:]}")
    if not (out.get("router_forwarded") and out["router_rc"] == 0
            and "native C++" in out["router_line"]):
        raise AssertionError(f"the router launch node failed: {out}; {lines[-10:]}")

    with open(os.path.join(ROOT, "configs", "launch", "iris_sdectrl.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(addr_mavlink_state_msg=f"127.0.0.1:{free_udp_port()}",
               addr_services=f"127.0.0.1:{free_udp_port()}",
               config_dir=os.path.join(ROOT, "configs"))
    repl_yaml = os.path.join(d, "launch", "iris_sdectrl.yaml")
    with open(repl_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", repl_yaml,
                        "--repl"], cwd=ROOT, input=SITL_REPL, capture_output=True, text=True,
                       timeout=LAUNCH_READY_S)
    out["repl_rc"], out["repl_wall_s"] = r.returncode, time.perf_counter() - t0
    text = r.stdout
    stopped = next((ln[ln.index("[launch] engine stopped"):] for ln in text.splitlines()
                    if "[launch] engine stopped" in ln), "")
    out["repl_stopped"] = stopped
    replies = [ln.split(">>> ")[-1] for ln in text.splitlines() if ">>> " in ln]
    log(f"--repl ({card}): rc {r.returncode} in {out['repl_wall_s']:.1f} s; mission replies "
        f"{[x for x in replies if x and x != stopped]}; {stopped}")
    if not (r.returncode == 0 and "[launch] READY" in text and "engine (cuda" in text
            and "Loaded the trajectory and the parameters" in text and "error:" not in text):
        raise AssertionError(f"--repl failed: rc {r.returncode}\n{text[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return out


def sitl_preflight(card: str) -> dict:
    """(d) ``sim/preflight.py --solve`` in this process, so its one
    ``apg_solve`` launch is counted. Gates: exit code 0, the device line
    naming the card, exactly one whole-solve launch."""
    import io

    from sde4mbrl_px4_tpu_torch.sim import preflight

    buf = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        rc = preflight.main(["--solve"])
    got = counts()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"preflight: {line.strip()}")
    device = next((ln for ln in text.splitlines() if " device " in ln), "")
    if rc != 0 or card.split(",")[0] not in device:
        raise AssertionError(f"preflight failed (rc {rc}): {text}")
    check_route("preflight solve", {"apg_solve": 1, "value_batch": 0, "value_and_grad": 0,
                                    "trajectory": 0})
    solve = next((ln for ln in text.splitlines() if "end-to-end solve" in ln), "")
    return {"rc": rc, "device_line": device.strip(), "solve_line": solve.strip(),
            "launches": got}


def phase_sitl(card: str) -> dict:
    """Phase 27, the SITL deployment stack (module docstring)."""
    t = time.perf_counter()
    out = {"router": sitl_router(card), "stack": sitl_stack(card),
           "launch": sitl_launch(card), "preflight": sitl_preflight(card)}
    out["wall_s"] = time.perf_counter() - t
    log(f"phase 27 took {out['wall_s']:.1f} s")
    return out


# ---- phase 28: reduced matmul precision (the bf16 trunk) -------------------
BF16_TICKS = 20                       # (b): chained flagship solves, each precision
BF16_MPPI_K, BF16_MPPI_P = 64, 256    # (a): MPPI's K candidates x P paths
BF16_P1_K = 256                       # MPPI at P=1 with the key: K > 128, XLA on the TPU
BF16_POLICY_TICKS = 4
# each bf16 form against its plain bf16 twin on the same inputs and draws,
# per compared output: the whole solve's plan (max |du|) and exit gradient
# (grad_sqr, relative), value_and_grad's value (relative) and gradient (max
# |dg| over max |g|), value_batch's costs (relative). The twins sum in other
# orders, and a last-bit difference in a pre-activation can flip its bf16
# rounding (one bf16 ulp is 2^-8 relative); a particle mean smooths such
# flips, a P=1 row does not: the P=1 value_batch's costs (and the pure
# policy's telemetry cost) read up to 1.7e-6 (measured on one H100), the
# particle forms' 2e-7. With risk the gradient's particle weights
# 1 + lambda (tot_p - m) / std amplify the totals' last bits: the fp32
# options form itself reads up to 8.5e-6 from its plain fp32 twin (P=1024,
# risk; the bf16 form up to 3.6e-6, both on one H100), so value_and_grad
# with risk is held at 1e-5 on its gradient.
BF16_TOL = {"apg_solve": {"du": 1e-6, "gsq": 5e-5},
            "value_and_grad": {"value": 1e-6, "grad": 1e-6},
            "value_and_grad_risk": {"value": 1e-6, "grad": 1e-5},
            "value_batch": {"cost": 5e-7}, "value_batch_P1": {"cost": 3e-6}}


def _rel(a, b) -> float:
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def _scaled(a, b) -> float:
    """max |a - b| over max |b|."""
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bf16_compare(tag: str, k16: dict, p16: dict, k32: dict, tol: dict) -> dict:
    """Each metric of a bf16 form: the kernel against its plain bf16 twin
    (``err``, gated at ``tol``, one of ``BF16_TOL``) and against the kernel's
    fp32 form (``gap``, gated at more than 10x the tolerance in at least one
    metric, so the check cannot pass without the rounding)."""
    import torch

    fns = {"du": lambda a, b: float((a - b).abs().max()), "gsq": _rel, "value": _rel,
           "grad": _scaled, "cost": _rel}
    err = {m: fns[m](k16[m], p16[m]) for m in k16}
    gap = {m: fns[m](k16[m], k32[m]) for m in k16}
    finite = all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in k16.values())
    log(f"bf16 form {tag}: against its plain bf16 twin "
        + ", ".join(f"{m} {err[m]:.3e} (tol {tol[m]:.0e})" for m in err)
        + "; against its fp32 form " + ", ".join(f"{m} {gap[m]:.3e}" for m in gap))
    if not (finite and all(err[m] <= tol[m] for m in err)):
        raise AssertionError(f"the bf16 form {tag} disagrees with its plain bf16 twin")
    if not any(gap[m] > 10 * tol[m] for m in gap):
        raise AssertionError(f"the bf16 form {tag} is within 10x its tolerance of its fp32 "
                             "form: the check would pass without the rounding")
    return {"err": err, "gap": gap}


def bf16_forms(dev, card: str) -> dict:
    """(a) every bf16 form against its plain bf16 twin (``bf16=True`` on the
    card's tensors) on the same inputs and draws, and against its own fp32
    form; its time per launch beside the fp32 form's and the plain twin's:
    the whole solve's particle form (a fixed 5-iteration P=512 antithetic
    traj solve, with its ``trajectory`` launch), ``value_and_grad`` and
    ``value_batch`` K = 1, 4 at P=512 antithetic, ``value_batch`` at K = 64 x
    P = 256 (MPPI's paths), and the P=1 ``value_batch`` at K = 256 on the
    register chain and at K = 64 on the shared-memory step (the trunk padded
    to 72 units)."""
    import torch

    from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    out = {}
    bt = make_bundle("iris_traj_mpc", dev)
    x0, x_ref, u_prev, u_init = problem(bt, dev)
    apg = bt.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    z = brownian(P_FULL, dev, antithetic=True, seed=0)
    args = (bt.model, bt.params, bt.cost_params, apg, bt.time_steps, x0, x_ref, u_prev, z,
            P_FULL, bt.lb, bt.ub, u_init)

    def solve(fn, bf16):
        st, _ = fn(*args, precond=bt.precond, bf16=bf16)
        return {"du": st.yk, "gsq": st.grad_sqr, "steps": int(st.num_steps)}

    k16, k32, p16 = (solve(AK.apg_solve_kernel, True), solve(AK.apg_solve_kernel, False),
                     solve(AK.apg_solve_plain, True))
    steps = {k16.pop("steps"), k32.pop("steps"), p16.pop("steps")}
    if len(steps) != 1:
        raise AssertionError(f"the bf16 whole solve's steps differ: {steps}")
    r = _bf16_compare(f"apg_solve (particles, P={P_FULL} antithetic, 5 iterations)", k16, p16,
                      k32, BF16_TOL["apg_solve"])
    r["ms"], r["plain_ms"] = time_fixed(AK, args, bt.precond, n_kernel=5, n_plain=1, bf16=True)
    r["fp32_ms"] = time_fixed(AK, args, bt.precond, n_kernel=5, n_plain=0)[0]
    shape = dict(P=P_FULL, K=4, iters=steps.pop())
    r["bound"] = bound(bt, "apg_solve", n_consts(bt, dev), **shape)
    r["bound_tc_ms"] = bound(bt, "apg_solve", n_consts(bt, dev), tc=True, **shape)[0]
    out["apg_solve"] = r

    bp = make_bundle("iris_posctrl_mpc", dev)
    x0, x_ref, u_prev, _ = problem(bp, dev)
    nc = n_consts(bp, dev)

    def oracles(P, noise, params=None):
        a = (bp.model, bp.params if params is None else params, bp.cost_params,
             bp.time_steps, x0, x_ref, u_prev, noise, P, 4)
        return CO.cost_oracle(*a, bf16=True), CO.cost_oracle(*a), CO.cost_oracle_plain(*a,
                                                                                      bf16=True)

    def vb_form(tag, name, trio, U, **shape):
        k16, k32, p16 = ({"cost": o.value_batch(U)} for o in trio)
        r = _bf16_compare(tag, k16, p16, k32,
                          BF16_TOL["value_batch" if shape.get("P", 1) > 1 else "value_batch_P1"])
        r["ms"] = per_launch_ms(lambda: trio[0].value_batch(U), 20)
        r["fp32_ms"] = per_launch_ms(lambda: trio[1].value_batch(U), 20)
        r["plain_ms"] = per_launch_ms(lambda: trio[2].value_batch(U), 2)
        r["bound"] = bound(bp, "value_batch", nc, **shape)
        r["bound_tc_ms"] = bound(bp, "value_batch", nc, tc=True, **shape)[0]
        out[name] = r

    trio = oracles(P_FULL, z)
    u = plans(1, 3, dev)[0].contiguous()
    k16, k32, p16 = ({"value": v, "grad": g}
                     for v, g in (o.value_and_grad(u) for o in trio))
    r = _bf16_compare(f"value_and_grad (particles, P={P_FULL} antithetic)", k16, p16, k32,
                      BF16_TOL["value_and_grad"])
    r["ms"] = per_launch_ms(lambda: trio[0].value_and_grad(u), 20)
    r["fp32_ms"] = per_launch_ms(lambda: trio[1].value_and_grad(u), 20)
    r["plain_ms"] = per_launch_ms(lambda: trio[2].value_and_grad(u), 2)
    r["bound"] = bound(bp, "value_and_grad", nc, P=P_FULL)
    r["bound_tc_ms"] = bound(bp, "value_and_grad", nc, P=P_FULL, tc=True)[0]
    out["value_and_grad"] = r
    for K in (1, 4):
        vb_form(f"value_batch (particles, P={P_FULL} antithetic, K={K})",
                f"value_batch_P{P_FULL}_K{K}", trio, plans(K, 4, dev), P=P_FULL, K=K)
    vb_form(f"value_batch (particles, K={BF16_MPPI_K} x P={BF16_MPPI_P} antithetic)",
            "value_batch_mppi", oracles(BF16_MPPI_P, brownian(BF16_MPPI_P, dev, True, seed=1)),
            plans(BF16_MPPI_K, 5, dev), P=BF16_MPPI_P, K=BF16_MPPI_K)
    vb_form(f"value_batch (P=1, register chain, K={BF16_P1_K})", "value_batch_P1",
            oracles(1, None), plans(BF16_P1_K, 6, dev), K=BF16_P1_K)
    vb_form(f"value_batch (P=1, shared-memory step, trunk of {PADDED_HID} units, K=64)",
            "value_batch_P1_smem", oracles(1, None, padded_trunk(bp.params, PADDED_HID, seed=0)),
            plans(64, 7, dev), K=64)
    for name, r in out.items():
        tc = r["bound_tc_ms"]
        log(f"bf16 {name} ({card}): {r['ms']:.4f} ms per launch (CUDA events), fp32 form "
            f"{r['fp32_ms']:.4f} ms, plain bf16 twin {r['plain_ms']:.3f} ms; bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}, fp32 CUDA cores), on bf16 tensor cores "
            f"{tc:.6f} ms")
    return out


def bf16_option_forms(dev, card: str) -> dict:
    """(a) the particle options' bf16 forms (``risk_lambda`` 2 with the
    example's state-noise starts, ``with_options``: the forms that
    ``sim/uncertainty.py`` and every risk or starts config above 128
    particles launch) against their plain bf16 twins on the same inputs and
    draws and against their own fp32 forms, at ``BF16_TOL`` (``value_and_grad``
    at its risk tolerance): at P=512
    antithetic (one chunk a block) and P=1024 antithetic (two chunks a
    block), the whole solve at a fixed 5 iterations, ``value_and_grad``,
    and ``value_batch`` at K = 1 and 4 (both launches' costs held as one
    set). Their times per launch beside the fp32 forms'."""
    import torch

    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

    out = {}
    b = make_bundle("iris_traj_mpc", dev)
    x0, x_ref, u_prev, u_init = problem(b, dev)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    for P in (P_FULL, P_LARGE):
        tag = f"P={P} antithetic, risk + starts" + (", two chunks a block" if P > P_FULL else "")
        z = brownian(P, dev, antithetic=True, seed=0)
        cp, starts = with_options(b, ("risk", "starts"), x0, P, dev, seed=P)
        args = (b.model, b.params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P, b.lb, b.ub,
                u_init)

        def solve(fn, bf16):
            st, _ = fn(*args, precond=b.precond, starts=starts, bf16=bf16)
            return {"du": st.yk, "gsq": st.grad_sqr, "steps": int(st.num_steps)}

        k16, k32, p16 = (solve(AK.apg_solve_kernel, True), solve(AK.apg_solve_kernel, False),
                         solve(AK.apg_solve_plain, True))
        steps = {k16.pop("steps"), k32.pop("steps"), p16.pop("steps")}
        if len(steps) != 1:
            raise AssertionError(f"the bf16 whole solve's steps differ ({tag}): {steps}")
        r = _bf16_compare(f"apg_solve ({tag}, 5 iterations)", k16, p16, k32,
                          BF16_TOL["apg_solve"])
        r["ms"] = time_fixed(AK, args, b.precond, n_kernel=5, n_plain=0, starts=starts,
                             bf16=True)[0]
        r["fp32_ms"] = time_fixed(AK, args, b.precond, n_kernel=5, n_plain=0, starts=starts)[0]
        out[f"apg_solve_P{P}"] = r

        oargs = (b.model, b.params, cp, b.time_steps, x0, x_ref, u_prev, z, P, 4)
        trio = (CO.cost_oracle(*oargs, starts=starts, bf16=True),
                CO.cost_oracle(*oargs, starts=starts),
                CO.cost_oracle_plain(*oargs, starts=starts, bf16=True))
        u = plans(1, 3, dev)[0].contiguous()
        k16, k32, p16 = ({"value": v, "grad": g}
                         for v, g in (o.value_and_grad(u) for o in trio))
        r = _bf16_compare(f"value_and_grad ({tag})", k16, p16, k32,
                          BF16_TOL["value_and_grad_risk"])
        r["ms"] = per_launch_ms(lambda: trio[0].value_and_grad(u), 10)
        r["fp32_ms"] = per_launch_ms(lambda: trio[1].value_and_grad(u), 10)
        out[f"value_and_grad_P{P}"] = r

        U = plans(4, 4, dev)
        k16, k32, p16 = ({"cost": torch.cat([o.value_batch(U[:1]), o.value_batch(U)])}
                         for o in trio)
        r = _bf16_compare(f"value_batch ({tag}, K = 1 and 4)", k16, p16, k32,
                          BF16_TOL["value_batch"])
        r["ms"] = per_launch_ms(lambda: trio[0].value_batch(U), 10)
        r["fp32_ms"] = per_launch_ms(lambda: trio[1].value_batch(U), 10)
        out[f"value_batch_P{P}"] = r
        log(f"bf16 options forms at {tag} ({card}): per launch (CUDA events) "
            + "; ".join(f"{k.rsplit('_P', 1)[0]} {out[k]['ms']:.4f} ms (fp32 form "
                        f"{out[k]['fp32_ms']:.4f} ms)"
                        for k in (f"apg_solve_P{P}", f"value_and_grad_P{P}",
                                  f"value_batch_P{P}")))
    return out


def bf16_flagship(dev, card: str) -> dict:
    """(b) the main path at full width: ``iris_traj_mpc.yaml`` on the shipped
    iris checkpoint at P=512 antithetic without the key (DEFAULT above 128
    particles: the bf16 trunk), ``BF16_TICKS`` chained solves through
    ``load_mpc_from_cfgfile`` -> ``mpc_fn`` along the lemniscate, one bf16
    ``apg_solve`` and one fp32 ``trajectory`` launch each and nothing else;
    then the same config at ``matmul_precision: highest`` in the same call.
    Wall (dispatch to the plan on the host) and device (CUDA events around
    the whole-solve wrapper and its trajectory launch) p50 over ticks 2..,
    iterations, and ``|x_evol[1] - ref|`` (gate 0.5 m, phase 12's)."""
    import numpy as np
    import torch
    import yaml

    from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile

    out = {}
    for key in ("default", "highest"):
        cfg0 = config("iris_traj_mpc", particles=P_FULL)
        if key == "highest":
            cfg0["matmul_precision"] = "highest"
        path = os.path.join(ROOT, "build", "chip_smoke", f"iris_traj_p{P_FULL}anti_{key}.yaml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump({k: v for k, v in cfg0.items() if not k.startswith("_")}, f)
        cfg, (reset_fn, mpc_fn), sft, _ = load_mpc_from_cfgfile(path, device=dev)
        dt, t0 = float(cfg["_time_steps"][0]), 3.0
        x = enu2ned(sft(np.float32(t0)))
        gen = torch.Generator().manual_seed(0)
        st = reset_fn(x, gen, x)
        events, wall, steps, track = [], [], [], []
        torch.cuda.synchronize()
        zero_counts()
        with routed("apg_solve_kernel", event_timed(events)):
            for k in range(BF16_TICKS):
                w0 = time.perf_counter()
                u, st, gen, x_evol = mpc_fn(x, gen, st, np.float32(t0 + k * dt), x)
                u0 = u[0].cpu()
                wall.append((time.perf_counter() - w0) * 1e3)
                steps.append(int(st.num_steps))
                x = x_evol[1]
                ref = enu2ned(sft(np.float32(t0 + (k + 1) * dt)))
                track.append(float(torch.linalg.norm(x[:3] - ref[:3])))
                if not (bool(torch.isfinite(u0).all()) and bool(torch.isfinite(x_evol).all())):
                    raise AssertionError(f"the P={P_FULL} {key} solve {k} is not finite")
        torch.cuda.synchronize()
        n = BF16_TICKS
        launches = check_route(f"P={P_FULL} antithetic flagship at {key}",
                               {"apg_solve": n, "value_batch": 0, "value_and_grad": 0,
                                "trajectory": n},
                               {"apg_solve": n if key == "default" else 0, "value_batch": 0,
                                "value_and_grad": 0})
        dev_ms = [a.elapsed_time(e) for a, e in events]
        r = {"launches": launches, "bf16_launches": bf16_counts(),
             "wall_ms_p50": statistics.median(wall[1:]),
             "device_ms_p50": statistics.median(dev_ms[1:]), "iterations": steps,
             "iteration_ms_p50": statistics.median(d / s for d, s in zip(dev_ms[1:], steps[1:])),
             "track_max_m": max(track)}
        log(f"flagship P={P_FULL} antithetic, matmul_precision {key} ({card}): {n} chained "
            f"solves, wall p50 {r['wall_ms_p50']:.3f} ms, device p50 {r['device_ms_p50']:.3f} ms "
            f"(solve + trajectory), per iteration p50 {r['iteration_ms_p50']:.4f} ms, iterations "
            f"{steps}, |x_evol[1] - ref| max {r['track_max_m']:.4f} m (gate 0.5 m)")
        if r["track_max_m"] > 0.5 or min(steps) < 1:
            raise AssertionError(f"the P={P_FULL} flagship at {key} did not track")
        out[key] = r
    return out


def bf16_routes(dev, card: str) -> dict:
    """(c) the other bf16 routes through ``mpc_fn``, each with its launches
    (zeroed just before it): the fixed-step route at P=512 antithetic
    (posctrl without its linesearch block, 20 iterations, 2 chained solves:
    bf16 ``value_batch`` and ``value_and_grad``, fp32 ``trajectory``);
    ``sim/uncertainty.py`` at P=1024, every variant (risk-averse and state
    noise among them; bf16 ``apg_solve``); MPPI at P=1 with ``matmul_precision: bf16`` and K = 256
    (the P=1 ``value_batch``'s bf16 form on the register chain), 3 chained
    solves through the kernels and through the plain bf16 oracle on the same
    draws (|du| <= 1e-4, equal steps, phase 7's gate); the pure policy on
    the shipped iris traj checkpoint with the key, 4 chained solves (its
    telemetry cost on the bf16 ``value_batch`` K=1, the network fp32),
    against the plain bf16 oracle (cost rtol 3e-6, the P=1 ``value_batch``'s
    tolerance; plan bit for bit) and against the same states through the
    route at ``matmul_precision: highest`` (the plan bit for bit, the cost
    more than 10x the tolerance away)."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
    from sde4mbrl_px4_tpu_torch.sim import uncertainty as UNC

    out = {}
    n = 2
    cfg = config("iris_posctrl_mpc", linesearch=None, stepsize=FIXED_STEP["iris_posctrl_mpc"],
                 particles=P_FULL, max_iter=20, max_no_improvement_iter=20)
    zero_counts()
    rows, ms = chain(cfg, dev, n)
    torch.cuda.synchronize()
    steps = int(rows[:, -1].sum())
    out["fixed_step"] = {"launches": check_route(
        f"fixed-step P={P_FULL} (bf16)",
        {"apg_solve": 0, "value_batch": steps, "value_and_grad": steps + 2 * n, "trajectory": n},
        {"apg_solve": 0, "value_batch": steps, "value_and_grad": steps + 2 * n}),
        "bf16_launches": bf16_counts(), "ms": ms, "iterations": rows[:, -1].tolist()}
    if not np.isfinite(rows).all():
        raise AssertionError("the bf16 fixed-step route returned a bad plan")

    zero_counts()
    unc = UNC.run(UNCERTAINTY_P, dev)
    torch.cuda.synchronize()
    nv = len(UNC.VARIANTS)
    out["uncertainty"] = {"launches": check_route(
        f"sim/uncertainty.py P={UNCERTAINTY_P} (bf16)",
        {"apg_solve": 2 * nv, "value_batch": 0, "value_and_grad": 0, "trajectory": 2 * nv},
        {"apg_solve": 2 * nv, "value_batch": 0, "value_and_grad": 0}),
        "bf16_launches": bf16_counts(), "variants": unc}
    if not all(np.isfinite([r["ms"], r["opt_cost"]]).all() for r in unc.values()):
        raise AssertionError("the bf16 uncertainty drive gave a non-finite reading")

    iters, n = 8, 3
    cfg = config("iris_posctrl_mpc", solver="mppi", mppi={"samples": BF16_P1_K, "iters": iters})
    cfg["matmul_precision"] = "bf16"
    zero_counts()
    rows_k, ms = chain(cfg, dev, n)
    torch.cuda.synchronize()
    launches = check_route(f"MPPI P=1 K={BF16_P1_K} matmul_precision bf16",
                           {"apg_solve": 0, "value_batch": n * (iters + 2), "value_and_grad": 0,
                            "trajectory": n},
                           {"apg_solve": 0, "value_batch": n * (iters + 2),
                            "value_and_grad": 0})
    with routed("cost_oracle", CO.cost_oracle_plain):
        rows_p, _ = chain(cfg, dev, n)
    du = float(np.abs(rows_k[:, :-1] - rows_p[:, :-1]).max())
    log(f"MPPI P=1 K={BF16_P1_K} bf16 ({card}): {n} chained solves, p50 "
        f"{statistics.median(ms[1:]):.3f} ms; kernels vs the plain bf16 oracle, same draws: "
        f"max|du| {du:.3e} (gate 1e-4), steps {rows_k[:, -1].tolist()} vs "
        f"{rows_p[:, -1].tolist()}")
    if not (du <= 1e-4 and np.array_equal(rows_k[:, -1], rows_p[:, -1])):
        raise AssertionError("bf16 MPPI through the kernels disagrees with the plain oracle")
    out["mppi_p1"] = {"launches": launches, "bf16_launches": {"value_batch": n * (iters + 2)},
                      "ms_p50": statistics.median(ms[1:]), "max_du": du}

    cfg = policy_config("iris", "traj")
    cfg["matmul_precision"] = "bf16"
    c, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
    dt = float(c["_time_steps"][0])
    x, t0 = policy_start(sft, dev)
    st = reset_fn(x, None, x)
    sols, ms = [], []
    zero_counts()
    for k in range(BF16_POLICY_TICKS):
        w0 = time.perf_counter()
        sol = mpc_fn(x, None, st, t0 + k * dt, x)
        float(sol.opt_state.opt_cost)
        ms.append((time.perf_counter() - w0) * 1e3)
        sols.append((x, st, sol))
        x, st = sol.x_evol[1], sol.opt_state
    torch.cuda.synchronize()
    n = BF16_POLICY_TICKS
    launches = check_route("the pure policy with matmul_precision bf16",
                           {"apg_solve": 0, "value_batch": n, "value_and_grad": 0,
                            "trajectory": n},
                           {"apg_solve": 0, "value_batch": n, "value_and_grad": 0})
    dc = 0.0
    with routed("cost_oracle", CO.cost_oracle_plain):
        _, (_, mpc_p), _, _ = make_mpc_from_config(copy.deepcopy(cfg), device=dev)
        for k, (xk, stk, sol) in enumerate(sols):
            one = mpc_p(xk, None, stk, t0 + k * dt, xk)
            if not torch.equal(one.u_opt, sol.u_opt):
                raise AssertionError("the bf16 policy's plan moved with the oracle")
            dc = max(dc, _rel(sol.opt_state.opt_cost, one.opt_state.opt_cost))
    # the same states through the route at matmul_precision highest: the
    # plan (the fp32 network) bit for bit, the cost (fp32 value_batch) more
    # than 10x the tolerance away, so the check above sees the rounding
    cfg32 = copy.deepcopy(cfg)
    cfg32["matmul_precision"] = "highest"
    _, (_, mpc_32), _, _ = make_mpc_from_config(cfg32, device=dev)
    gap = 0.0
    for k, (xk, stk, sol) in enumerate(sols):
        one = mpc_32(xk, None, stk, t0 + k * dt, xk)
        if not torch.equal(one.u_opt, sol.u_opt):
            raise AssertionError("the policy's plan moved with matmul_precision")
        gap = max(gap, _rel(sol.opt_state.opt_cost, one.opt_state.opt_cost))
    tol = BF16_TOL["value_batch_P1"]["cost"]
    log(f"pure policy, iris traj, bf16 telemetry cost ({card}): {n} chained solves, p50 "
        f"{statistics.median(ms[1:]):.3f} ms; the cost against the plain bf16 oracle rel "
        f"{dc:.3e} (gate {tol:.0e}), against the route at highest rel {gap:.3e} (gate > "
        f"{10 * tol:.0e})")
    if dc > tol:
        raise AssertionError("the bf16 policy cost disagrees with the plain oracle")
    if gap <= 10 * tol:
        raise AssertionError("the bf16 policy cost is within 10x its tolerance of the fp32 "
                             "route's: the check would pass without the rounding")
    out["policy"] = {"launches": launches, "bf16_launches": {"value_batch": n},
                     "ms_p50": statistics.median(ms[1:]), "cost_rel": dc, "gap_to_fp32": gap}
    return out


def bf16_route_table(dev) -> list:
    """(d) per config, its matmul precision on the card (``MPCPieces.
    trunk_bf16``) and the forms its solves launch; one line each."""
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc

    rows = []
    # (name, config, key, whether the card runs it bf16, the forms it launches)
    cases = [
        ("APG P=1 (flight configs), key default", config("iris_traj_mpc"), "default", False,
         "apg_solve<false> (Pallas on the TPU)"),
        (f"APG P={P_FULL} antithetic, no key", config("iris_traj_mpc", particles=P_FULL), None,
         True, "apg_solve<true> bf16 + trajectory fp32"),
        (f"APG P={P_FULL} antithetic, highest", config("iris_traj_mpc", particles=P_FULL),
         "highest", False, "apg_solve<true> + trajectory"),
        ("APG P=128 antithetic, key bf16", config("iris_traj_mpc", particles=128), "bf16",
         False, "apg_solve<true> (Pallas on the TPU)"),
        (f"fixed step P={P_FULL}, no key",
         config("iris_posctrl_mpc", linesearch=None, particles=P_FULL), None, True,
         "value_and_grad<true> and value_batch<true> bf16 + trajectory fp32"),
        ("MPPI P=1 K=64, key bf16", config("iris_posctrl_mpc", solver="mppi"), "bf16", False,
         "value_batch<false, register chain> (Pallas on the TPU)"),
        (f"MPPI P=1 K={BF16_P1_K}, key bf16",
         config("iris_posctrl_mpc", solver="mppi", mppi={"samples": BF16_P1_K}), "bf16", True,
         "value_batch<false, register chain, bf16> + trajectory fp32"),
        (f"MPPI K={BF16_MPPI_K} x P={BF16_MPPI_P}",
         config("iris_posctrl_mpc", solver="mppi", particles=BF16_MPPI_P), None, True,
         "value_batch<true> bf16 + trajectory fp32"),
        ("pure policy, key bf16", policy_config("iris", "traj"), "bf16", True,
         "value_batch<false, register chain, bf16> K=1 + trajectory fp32, the network fp32"),
        ("policy refine_iters 15, key bf16", policy_config("iris", "traj", 15), "bf16", False,
         "apg_solve<false> (Pallas on the TPU)"),
    ]
    for name, cfg, key, want, forms in cases:
        if key is not None:
            cfg["matmul_precision"] = key
        bf16 = build_mpc(copy.deepcopy(cfg), device=dev)[2].trunk_bf16
        log(f"route table: {name}: the trunk on the card in {'bf16' if bf16 else 'fp32'}; "
            f"launches {forms}")
        rows.append({"config": name, "bf16": bf16, "forms": forms})
        if bf16 != want:
            raise AssertionError(f"the route table's {name}: trunk_bf16 {bf16}")
    return rows


def phase_bf16(dev, card: str) -> dict:
    """Phase 28: reduced matmul precision (module docstring)."""
    out = {"forms": bf16_forms(dev, card), "option_forms": bf16_option_forms(dev, card)}
    out["flagship"] = bf16_flagship(dev, card)
    out["routes"] = bf16_routes(dev, card)
    out["table"] = bf16_route_table(dev)
    return out


# the mesh layer (phase 29): rank pairs on the one card, each rank cuda:0
MESH_RANKS = 2
MESH_B, MESH_STEPS = BATCH_B, 3         # (a) iris posctrl, 50-iteration budget
MESH_FIXED_ITERS, MESH_SOLVES = 5, 3    # (b) the P=512 flagship over mc = 2
MESH_FLEET, MESH_TICKS = 64, 4          # (c)
MESH_LABELS, MESH_TUNE_STEPS = 64, 10   # (d)
MESH_S = 900.0                          # the pair's time limit
MESH_TOL = (2e-4, 2e-5)                 # tests/test_sharding.py:103-104
MESH_DEVICES = None                     # each rank's device: None the card (cuda:0)


def phase_mesh(dev, card: str) -> dict:
    """Phase 29, the mesh layer (``parallel/mesh.py``, ``distributed.py``):
    one pair of fresh rank processes on the card (gloo, both ranks on
    ``cuda:0``, ``spawn_ranks``) runs ``rank_tasks.suite``, each route with
    its launch counts zeroed just before it and read just after, and this
    process runs the one-process references:

    (a) dp: iris posctrl at B = 256 (50 iterations) over (2, 1), a cold and
        two warm steps: every scenario's plan and iterations bit-equal to
        the one-process batched solve; each rank's device ms per step, the
        ms of one gather; one ``apg_solve`` launch a rank a step;
    (b) mc: the P=512 antithetic flagship (iris traj) at a fixed 5
        iterations over (1, 2), 3 chained solves: against the one-process
        host loop (a (1, 1) mesh) on the same draws and against the
        one-process whole-solve kernel at the same budget, rtol 2e-4 /
        atol 2e-5; ms an iteration and the collectives' share of it;
        ``value_and_grad`` and ``value_batch`` launches on both ranks,
        ``trajectory`` on rank 0 only;
    (c) fleet: 64 vehicles over (2, 1), 4 ticks: the closed-loop states
        equal to the one-process fleet's;
    (d) ``label_states`` (64 states) and ``tune_cost_weights`` (27
        candidates, 10 periods) over (2, 1): each row equal to the
        one-process row;
    (e) ``launch.py --coordinator``: two engine nodes on the card as a
        world of two, READY, and a clean SIGTERM."""
    import numpy as np
    import torch

    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu_torch.learning import distill as TD
    from sde4mbrl_px4_tpu_torch.parallel import rank_tasks as RT
    from sde4mbrl_px4_tpu_torch.parallel.distributed import spawn_ranks
    from sde4mbrl_px4_tpu_torch.parallel.mesh import make_mesh
    from sde4mbrl_px4_tpu_torch.tuning import make_weight_grid

    t0 = time.perf_counter()
    pos = config("iris_posctrl_mpc", max_iter=BATCH_ITERS, max_no_improvement_iter=BATCH_ITERS)
    flag = config("iris_traj_mpc", particles=P_FULL, max_iter=MESH_FIXED_ITERS,
                  max_no_improvement_iter=MESH_FIXED_ITERS, atol=0.0, rtol=0.0)
    fleet_cfg = config("iris_posctrl_mpc")
    label_cfg = config("iris_posctrl_mpc")
    dcfg = TD.DistillConfig(expert_max_iter=100)
    b_lab = make_mpc_from_config(TD._expert_cfg(label_cfg, dcfg), device=dev)[3]
    xs, ts, xdes, ups = (a.cpu() for a in TD.sample_states(
        b_lab, MESH_LABELS, torch.Generator().manual_seed(5), dcfg))
    grid = make_weight_grid([0.5, 1.0, 2.0], [0.5, 1.0, 2.0], [0.5, 1.0, 2.0], [1.0])
    tune_cfg = config("iris_posctrl_mpc")
    devs = dict(devices=MESH_DEVICES)
    routes = [
        ("dp_solve", dict(cfg=pos, B=MESH_B, steps=MESH_STEPS, shape=(MESH_RANKS, 1), **devs)),
        ("particle_solve", dict(cfg=flag, solves=MESH_SOLVES, shape=(1, MESH_RANKS), **devs)),
        ("fleet", dict(cfg=fleet_cfg, B=MESH_FLEET, ticks=MESH_TICKS, shape=(MESH_RANKS, 1),
                       **devs)),
        ("labels", dict(cfg=label_cfg, xs=xs, ts=ts, xdes=xdes, u_prevs=ups,
                        expert_max_iter=dcfg.expert_max_iter, shape=(MESH_RANKS, 1), **devs)),
        ("tune", dict(kind="weights", cfg=tune_cfg, grid=grid, steps=MESH_TUNE_STEPS,
                      shape=(MESH_RANKS, 1), **devs))]
    ranks = spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:suite", MESH_RANKS,
                        {"routes": routes}, timeout=MESH_S, threads=None)
    spawn_s = time.perf_counter() - t0
    (dp, mc, fl, lab, tune) = zip(*ranks)
    out = {"ranks": MESH_RANKS, "spawn_s": spawn_s, "launches": {}}

    # (a) dp against one process
    one = RT.dp_solve(copy.deepcopy(pos), MESH_B, steps=MESH_STEPS, **devs)
    for r in dp:
        for k in range(MESH_STEPS):
            if not (np.array_equal(r["u"][k], one["u"][k])
                    and np.array_equal(r["num_steps"][k], one["num_steps"][k])):
                raise AssertionError(f"mesh (a): rank {r['rank']} step {k} is not bit-equal "
                                     f"to the one-process batched solve")
        if r["rows"] != MESH_B // MESH_RANKS:
            raise AssertionError(f"mesh (a): rank {r['rank']} solved {r['rows']} rows")
        mesh_launched("(a)", r["launches"], {"apg_solve": MESH_STEPS, "value_batch": 0,
                                             "value_and_grad": 0, "trajectory": 0})
    out["dp"] = {"B": MESH_B, "rows_per_rank": dp[0]["rows"],
                 "device_ms_per_step": [r["device_ms"] for r in dp],
                 "wall_ms_per_step": [r["wall_ms"] for r in dp],
                 "one_process_device_ms_per_step": one["device_ms"],
                 "gather_ms": [r["gather_ms"] for r in dp],
                 "iterations_mean": float(np.mean(one["num_steps"][-1]))}
    out["launches"]["dp"] = [r["launches"] for r in dp]
    r3 = lambda vs: [None if v is None else round(v, 3) for v in vs]
    log(f"phase 29 (a): dp over {MESH_RANKS} ranks, B={MESH_B}: every scenario's plan "
        f"bit-equal to one process over {MESH_STEPS} steps; device ms per step by rank "
        f"{[r3(r['device_ms']) for r in dp]} (one process {r3(one['device_ms'])}); gather ms "
        f"{r3([r['gather_ms'] for r in dp])} ({card})")

    # (b) mc against the one-process host loop and the whole-solve kernel
    loop = RT.particle_solve(copy.deepcopy(flag), solves=MESH_SOLVES, shape=(1, 1), **devs)
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(copy.deepcopy(flag), device=dev)
    from sde4mbrl_px4_tpu_torch.core.types import hover_state

    x0 = hover_state(dev)
    x0[0] = 0.4
    gen = torch.Generator().manual_seed(3)
    st = reset_fn(x0, gen, x0)
    kern = []
    for _ in range(MESH_SOLVES):
        sol = mpc_fn(x0, gen, st, 0.0, x0)
        st = sol.opt_state
        kern.append(sol.u_opt.cpu().numpy())
    rtol, atol = MESH_TOL
    err = {"loop": 0.0, "kernel": 0.0}
    for r in mc:
        for k in range(MESH_SOLVES):
            for name, ref in (("loop", loop["plans"][k]), ("kernel", kern[k])):
                if not np.allclose(r["plans"][k], ref, rtol=rtol, atol=atol):
                    raise AssertionError(f"mesh (b): rank {r['mc_index']} solve {k} differs "
                                         f"from the one-process {name} beyond {MESH_TOL}")
                err[name] = max(err[name], float(np.abs(r["plans"][k] - ref).max()))
        if r["iterations"] != [float(MESH_FIXED_ITERS)] * MESH_SOLVES:
            raise AssertionError(f"mesh (b): iterations {r['iterations']}")
        # x_evol is rank 0's trajectory launch, broadcast
        mesh_launched("(b)", r["launches"], {
            "apg_solve": 0, "trajectory": MESH_SOLVES if r["mc_index"] == 0 else 0,
            "value_and_grad": MESH_SOLVES * (MESH_FIXED_ITERS + 2),
            "value_batch": MESH_SOLVES * MESH_FIXED_ITERS})
    if not np.array_equal(mc[0]["plans"][-1], mc[1]["plans"][-1]):
        raise AssertionError("mesh (b): the ranks' plans differ")
    it_ms = [[w / MESH_FIXED_ITERS for w in r["wall_ms"]] for r in mc]
    share = [r["collective_s"] * 1e3 / sum(r["wall_ms"]) for r in mc]
    out["mc"] = {"P": P_FULL, "mc": MESH_RANKS, "iterations": MESH_FIXED_ITERS,
                 "ms_per_iteration": it_ms,
                 "one_process_loop_ms_per_iteration": [w / MESH_FIXED_ITERS
                                                       for w in loop["wall_ms"]],
                 "collective_share": share,
                 "collective_calls": [r["collective_calls"] for r in mc],
                 "max_abs_err_vs_loop": err["loop"], "max_abs_err_vs_kernel": err["kernel"]}
    out["launches"]["mc"] = [r["launches"] for r in mc]
    log(f"phase 29 (b): P={P_FULL} over mc={MESH_RANKS}, {MESH_FIXED_ITERS} iterations: "
        f"max|du| {err['loop']:.3e} vs the one-process host loop, {err['kernel']:.3e} vs "
        f"the whole-solve kernel; ms an iteration by rank {[r3(r) for r in it_ms]} "
        f"(one-process loop {r3(out['mc']['one_process_loop_ms_per_iteration'])}), the "
        f"collectives {[round(100 * v, 1) for v in share]} % of it ({card})")

    # (c) the fleet
    f1 = RT.fleet(copy.deepcopy(fleet_cfg), MESH_FLEET, ticks=MESH_TICKS, **devs)
    for r in fl:
        if not np.array_equal(r["states"], f1["states"]):
            raise AssertionError("mesh (c): the fleet's states differ from one process's")
        mesh_launched("(c)", r["launches"], {"apg_solve": MESH_TICKS, "value_batch": 0,
                                             "value_and_grad": 0, "trajectory": 0})
    out["fleet"] = {"vehicles": MESH_FLEET, "ticks": MESH_TICKS,
                    "tick_wall_ms": [r["wall_ms"] for r in fl],
                    "one_process_tick_wall_ms": f1["wall_ms"]}
    out["launches"]["fleet"] = [r["launches"] for r in fl]

    # (d) labels and the weight sweep
    lab1 = TD.label_states(label_cfg, xs, ts, xdes, None, dcfg, u_prevs=ups, device=dev)
    tune1 = RT.tune("weights", copy.deepcopy(tune_cfg), grid, steps=MESH_TUNE_STEPS,
                    shape=(1, 1), **devs)
    for r, t in zip(lab, tune):
        if not np.array_equal(r["labels"], lab1.cpu().numpy()):
            raise AssertionError("mesh (d): a label row differs from one process's")
        if [tuple(x) for x in t["results"]] != [tuple(x) for x in tune1["results"]]:
            raise AssertionError("mesh (d): a tuning row differs from one process's")
        zero = {"value_batch": 0, "value_and_grad": 0, "trajectory": 0}
        mesh_launched("(d) labels", r["launches"], {"apg_solve": 1, **zero})
        mesh_launched("(d) tuning", t["launches"], {"apg_solve": MESH_TUNE_STEPS, **zero})
    out["labels"] = {"n": MESH_LABELS, "wall_ms": [r["wall_ms"] for r in lab]}
    out["tuning"] = {"candidates": len(grid), "periods": MESH_TUNE_STEPS,
                     "wall_ms": [t["wall_ms"] for t in tune],
                     "one_process_wall_ms": tune1["wall_ms"]}
    out["launches"]["labels"] = [r["launches"] for r in lab]
    out["launches"]["tuning"] = [t["launches"] for t in tune]
    log(f"phase 29 (c)-(d): the {MESH_FLEET}-vehicle fleet's states over {MESH_TICKS} ticks, "
        f"{MESH_LABELS} labels and {len(grid)} tuning candidates equal one process's, row "
        f"for row")

    # (e) the launcher's world of two
    out["launch"] = mesh_launch_pair()
    out["wall_s"] = time.perf_counter() - t0
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    return out


def mesh_launched(route: str, got: dict, want: dict) -> None:
    """A rank's launches over a phase-29 route (zeroed just before it in the
    rank) against what the route is made of."""
    if got != want:
        raise AssertionError(f"mesh {route}: a rank launched {got}, the route needs {want}")


def mesh_launch_pair() -> dict:
    """Two ``launch.py --coordinator tcp://... --num-processes 2
    --process-id r`` engine nodes on the card (the shipped iris configs,
    free ports): each prints its rank and READY within ``LAUNCH_READY_S``,
    and exits 0 with its stop line on SIGTERM."""
    import signal
    import socket
    import threading

    import yaml

    d = os.path.join(ROOT, "build", "chip_smoke", "mesh_launch")
    os.makedirs(d, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(MESH_RANKS):
            lf = os.path.join(d, f"engine{r}.yaml")
            with open(lf, "w") as f:
                yaml.safe_dump({"node": "sde_control", "config_dir": os.path.join(ROOT, "configs"),
                                "traj_ctrl": "iris_traj_mpc.yaml",
                                "sp_ctrl": "iris_posctrl_mpc.yaml",
                                "addr_mavlink_state_msg": f"127.0.0.1:{free_udp_port()}",
                                "addr_services": f"127.0.0.1:{free_udp_port()}"}, f)
            p = subprocess.Popen(
                [sys.executable, "-m", "sde4mbrl_px4_tpu_torch.launch", lf, "--coordinator",
                 f"tcp://127.0.0.1:{port}", "--num-processes", str(MESH_RANKS),
                 "--process-id", str(r)] + (["--cpu"] if MESH_DEVICES == "cpu" else []),
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            lines = []
            threading.Thread(target=lambda p=p, lines=lines: lines.extend(p.stdout),
                             daemon=True).start()
            procs.append(p)
            logs.append(lines)
        while not all(any("[launch] READY" in ln for ln in lg) for lg in logs):
            if time.perf_counter() - t0 > LAUNCH_READY_S or any(p.poll() is not None
                                                                 for p in procs):
                raise AssertionError(f"mesh (e): the pair did not serve: "
                                     f"{[lg[-10:] for lg in logs]}")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    time.sleep(0.5)
    for r, (p, lg) in enumerate(zip(procs, logs)):
        text = "".join(lg)
        if not (p.returncode == 0 and f"[launch] rank {r} of {MESH_RANKS} (gloo)" in text
                and "[launch] engine stopped" in text and "Traceback" not in text):
            raise AssertionError(f"mesh (e): rank {r} rc {p.returncode}: {lg[-15:]}")
    log(f"phase 29 (e): launch.py --coordinator: {MESH_RANKS} engine nodes on the card served "
        f"in {ready_s:.1f} s and stopped cleanly on SIGTERM")
    return {"ready_s": ready_s, "rc": [p.returncode for p in procs]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy

    apply_fp32_policy()
    dev = torch.device("cuda")
    # a config whose metric is not committed probes it (phase 25): its file
    # goes to a temporary cache, not into the checkout
    precond_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_precond_")
    os.environ["SDE4MBRL_PRECOND_CACHE"] = precond_cache.name
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
    batched = phase_batched(dev, card)
    fleet = phase_fleet(card)
    log("phase 20: the batched solves equal their solo kernel solves on the scenario grid, "
        "and the fleet demo passes")
    policy = phase_policy(dev, card)
    log("phase 21: the policy family (the shipped checkpoints, pure and refine_iters) runs "
        "on the card and matches its plain version; the hybrid closed loop passes")
    boracle = phase_batched_oracle(dev, card)
    log("phase 22: the oracle kernels' scenario axis equals the solo launches; batched MPPI, "
        "fixed-step and policy solves equal their solo solves; both fleets pass")
    popt = phase_particle_options(dev, card)
    log(f"phase 23: the risk and start branches of the particle kernels match their plain "
        f"versions (max|err| {popt['err']}) and give the bits of one block on any cluster")
    proute = phase_particle_option_routes(dev, card)
    log("phase 24: MPPI over K x P paths, the fixed-step and batched routes with risk and "
        "starts, and both uncertainty drives run on the particle kernels; risk backs off the "
        "floor")
    learn = phase_learning(dev, card)
    log("phase 25: the learning loop runs on the card: a logged flight, the SDE fitted to it, "
        "its metric probed and flown, a policy distilled from batched whole-solve labels and "
        "served, a 32-wide trunk refused at build")
    tune = phase_tuning(dev, card)
    log("phase 26: the MPPI and weight sweeps run their candidates on the kernels' scenario "
        "axis, each checked candidate bit-equal to its solo solve; the mismatch sweep passes "
        "with the geometric baseline; the geometric launch node serves")
    sitl = phase_sitl(card)
    log("phase 27: the SITL deployment stack: both routers route the test topology, the full "
        "stack flies the engine node on the card through the native router and passes, the "
        "router node and the mission REPL serve, preflight's solve is one whole-solve launch")
    bf = phase_bf16(dev, card)
    log("phase 28: reduced matmul precision: every bf16 form matches its plain bf16 twin and "
        "differs from its fp32 form; the P=512 flagship runs one bf16 apg_solve and one fp32 "
        "trajectory per solve; the fixed-step, uncertainty, MPPI and policy routes run their "
        "bf16 forms")
    mesh = phase_mesh(dev, card)
    log("phase 29: the mesh layer: rank pairs on the card over gloo; dp batched solves, the "
        "fleet, labels and the weight sweep equal one process row for row, the P=512 "
        "particle-sharded solve matches the host loop and the whole-solve kernel, and a "
        "launch.py world of two serves and stops cleanly")

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

    runs, part = batched["runs"], batched["part"]
    b_batch, r = batched["bundle"], batched["runs"][BATCH_B]
    kernels += [
        entry("apg_solve", f"P=1, batched B={BATCH_B}", r["launches"]["apg_solve"],
              batched["du"], r["device_ms_p50"], batched["plain_ms"],
              bound(b_batch, "apg_solve", nc_pos, K=4, iters=r["steps_per_solve"], B=BATCH_B),
              timed=f"one batched step of {BATCH_B} re-targeted iris posctrl solves at a "
                    f"{BATCH_ITERS}-iteration budget, device p50",
              plain_ms_is="one scenario's plain solve (apg_solve_plain on the card)",
              wall_ms_p50=r["wall_ms_p50"], steps_per_solve=r["steps_per_solve"],
              solves_per_s=r["solves_per_s"],
              batched_steps={str(B): {k: v for k, v in run.items() if k != "launches"}
                             for B, run in runs.items()},
              bit_equal_to_solo=batched["bit_equal"],
              fleet_launches=fleet["launches"]["apg_solve"]),
        entry("apg_solve", f"particles, batched B={PART_B}", part["launches"]["apg_solve"],
              part["du"], part["ms"], part["plain_ms"],
              bound(b_traj, "apg_solve", nc_traj, P=P_FULL, K=4,
                    iters=statistics.mean(part["steps"]), B=PART_B),
              timed=f"one batched fixed 5-iteration P={P_FULL} antithetic solve of {PART_B} "
                    f"scenarios with its batched trajectory launch",
              plain_ms_is="one scenario's plain solve (apg_solve_plain on the card)",
              iterations=part["steps"], **batched["cluster"]),
        entry("trajectory", f"batched B={PART_B} (x_evol of the batched P={P_FULL} solve)",
              part["launches"]["trajectory"], batched["traj"]["err"], batched["traj"]["ms"],
              batched["traj"]["plain_ms"],
              bound(b_traj, "trajectory", batched["n_consts"], B=PART_B),
              timed=f"per launch over {PART_B} plans",
              plain_ms_is="one plan's plain rollout (rollout_mean on the card)")]
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
    # slice 10: the hybrid's route of #1, the scenario axis of #2 and #3
    bo, tk = boracle["oracle"], policy["ticks"]
    nc_b, b_b = boracle["n_consts"]["pos"], boracle["bundles"]["pos"]
    vb_p1 = {f"B={B},K={K}": r["ms"][("value_batch", K)]
             for (form, B), r in bo.items() if form == "P=1" for K in ORACLE_K}
    r64, rpart = bo[("P=1", SOLVE_B)], bo[(f"P={P_FULL}", PART_B)]
    kernels += [
        entry("apg_solve", "P=1, the policy hybrid (refine_iters 15, iris traj)",
              tk[15]["launches"]["apg_solve"], policy["hybrid"][15]["du"],
              tk[15]["device_ms_p50"], policy["hybrid"][15]["plain_ms"],
              bound(b_traj, "apg_solve", nc_traj, K=4, iters=tk[15]["steps"]),
              timed=f"chained hybrid ticks, device span per solve p50 (the network's three "
                    f"GEMMs and the select included) at {tk[15]['steps']:.1f} iterations",
              wall_ms_p50=tk[15]["wall_ms_p50"], refine_3_wall_ms_p50=tk[3]["wall_ms_p50"],
              refine_3_device_ms_p50=tk[3]["device_ms_p50"],
              closed_loop_launches=policy["closed_loop"][15]["launches"]["apg_solve"],
              batched_B256_launches=boracle["policy_15_launches"]["apg_solve"],
              fleet_launches=boracle["fleet"]["policy 15"]["launches"]["apg_solve"]),
        entry("value_batch", "P=1, K=1, the pure policy's telemetry cost",
              tk[0]["launches"]["value_batch"], max(p["cost_rel"] for p in
                                                    policy["pure"].values()),
              bo[("P=1", 1)]["ms"][("value_batch", 1)], bo[("P=1", 1)]["plain_ms"],
              bound(b_b, "value_batch", nc_b, K=1),
              timed="per launch, K=1", max_abs_err_is="the telemetry cost's relative error",
              pure_wall_ms_p50=tk[0]["wall_ms_p50"], pure_device_ms_p50=tk[0]["device_ms_p50"],
              closed_loop_launches=policy["closed_loop"][0]["launches"]["value_batch"],
              batched_B256_launches=boracle["policy_0_launches"]["value_batch"]),
        entry("value_batch", f"P=1, batched (scenario axis, grid rows; B in {ORACLE_B})",
              boracle["mppi_launches"]["value_batch"],
              max(r["vb_err"] for (form, _), r in bo.items() if form == "P=1"),
              r64["ms"][("value_batch", 64)], r64["plain_ms"],
              bound(b_b, "value_batch", nc_b, K=64, B=SOLVE_B),
              timed=f"per launch over B={SOLVE_B} x K=64 plans (a batched MPPI round)",
              plain_ms_is="one scenario's plain value_batch at K=64",
              max_abs_err_is="relative to the plain oracle", ms_by_shape=vb_p1,
              bound_ms_B256_K64=bound(b_b, "value_batch", nc_b, K=64, B=256)[0],
              padded_max_rel=bo[("padded", PART_B)]["vb_err"],
              prox_max_rel=bo[("prox", PART_B)]["vb_err"],
              fleet_launches=boracle["fleet"]["mppi"]["launches"]["value_batch"]),
        entry("value_batch", f"P={P_FULL} antithetic, batched B={PART_B}",
              boracle["part_launches"]["value_batch"], rpart["vb_err"],
              rpart["ms"][("value_batch", 1)], rpart["plain_ms"],
              bound(boracle["bundles"]["part"], "value_batch", nc_b, P=P_FULL, K=1, B=PART_B),
              timed=f"per launch over B={PART_B} x K=1 plans",
              plain_ms_is="one scenario's plain value_batch at K=4",
              ms_K4=rpart["ms"][("value_batch", 4)]),
        entry("value_and_grad", f"P=1, batched (B in {VG_B})",
              boracle["fixed_launches"]["value_and_grad"],
              max(r["vg_err"] for (form, _), r in bo.items() if form == "P=1"),
              r64["ms"]["value_and_grad"], timing["value_and_grad"][1],
              bound(b_b, "value_and_grad", nc_b, B=SOLVE_B),
              timed=f"per launch over B={SOLVE_B} plans (a batched fixed-step iteration)",
              plain_ms_is="one plan's plain value_and_grad (phase 9)",
              ms_B256=bo[("P=1", 256)]["ms"]["value_and_grad"],
              prox_max_abs_err=bo[("prox", PART_B)]["vg_err"]),
        entry("value_and_grad", f"P={P_FULL} antithetic, batched B={PART_B}",
              boracle["part_launches"]["value_and_grad"], rpart["vg_err"],
              rpart["ms"]["value_and_grad"], part_oracle["value_and_grad"][1],
              bound(boracle["bundles"]["part"], "value_and_grad", nc_b, P=P_FULL, B=PART_B),
              timed=f"per launch over B={PART_B} plans",
              plain_ms_is=f"one plan's plain value_and_grad at P={P_FULL} (phase 13)")]
    # slice 11: the particle options on the particle forms of #1-#3
    b_opt, fx, fx2 = popt["bundle"], popt[f"fixed_P{P_FULL}"], popt[f"fixed_P{P_LARGE}"]
    nc_opt, lo = n_consts(b_opt, dev), proute["launches"]
    om = popt["oracle_ms"]
    kernels += [
        entry("apg_solve", "particles with risk_lambda and initial_state_std",
              sum(lo[r]["apg_solve"] for r in ("batched", "uncertainty", "noise_robustness")),
              popt["err"]["apg_solve"], fx["risk"][0], fx["risk"][1],
              bound(b_opt, "apg_solve", nc_opt, P=P_FULL, K=4, iters=5),
              timed=f"fixed 5-iteration solve at P={P_FULL} antithetic with risk (lambda "
                    f"{RISK}), with its trajectory launch",
              ms_without_options=fx["none"][0], ms_starts=fx["starts"][0],
              ms_risk_and_starts=fx["risk + starts"][0],
              bound_ms_starts=bound(b_opt, "apg_solve", nc_opt, P=P_FULL, K=4, iters=5,
                                    starts=True)[0],
              P1024_ms_without_risk=fx2["none"][0], P1024_ms_risk=fx2["risk"][0],
              P1024_plain_ms_risk=fx2["risk"][1],
              P1024_bound_ms=bound(b_opt, "apg_solve", nc_opt, P=P_LARGE, K=4, iters=5)[0],
              route_launches={r: lo[r]["apg_solve"]
                              for r in ("batched", "uncertainty", "noise_robustness")},
              uncertainty_ms={k: v["ms"] for k, v in proute["uncertainty"].items()}),
        entry("value_and_grad", "particles with risk_lambda and initial_state_std",
              lo["fixed_step"]["value_and_grad"], popt["err"]["value_and_grad"],
              om["risk"]["value_and_grad"], om["risk"]["plain_value_and_grad"],
              bound(b_opt, "value_and_grad", nc_opt, P=P_FULL),
              timed=f"per launch at P={P_FULL} antithetic with risk",
              ms_without_options=om["none"]["value_and_grad"],
              ms_starts=om["starts"]["value_and_grad"],
              ms_risk_and_starts=om["risk + starts"]["value_and_grad"]),
        entry("value_batch", "particles with risk_lambda and initial_state_std",
              lo["fixed_step"]["value_batch"], popt["err"]["value_batch"],
              om["risk"]["value_batch_K1"], om["risk"]["plain_value_batch_K1"],
              bound(b_opt, "value_batch", nc_opt, P=P_FULL, K=1),
              timed=f"per launch at P={P_FULL} antithetic with risk, K=1",
              ms_K4=om["risk"]["value_batch_K4"],
              bound_ms_K4=bound(b_opt, "value_batch", nc_opt, P=P_FULL, K=4)[0],
              ms_without_options=om["none"]["value_batch_K1"],
              ms_risk_and_starts_K4=om["risk + starts"]["value_batch_K4"]),
        entry("value_batch", f"particles, MPPI over K={MPPI_K} x P={MPPI_P} antithetic paths",
              lo["mppi"]["value_batch"], proute["mppi"]["max_du"], proute["mppi"]["ms"],
              proute["mppi"]["plain_ms"],
              bound(proute["mppi"]["bundle"], "value_batch", nc_opt, P=MPPI_P, K=MPPI_K),
              timed=f"per launch, K={MPPI_K} x P={MPPI_P}",
              max_abs_err_is="max |du| of the chained MPPI plans, kernels vs plain",
              solve_ms_p50=proute["mppi"]["wall_ms_p50"],
              plain_solve_ms_p50=proute["mppi"]["plain_wall_ms_p50"])]
    # phase 25: the distillation labels and the retrained checkpoint on #1
    lp, ld = learn["probe"], learn["distill"]
    for kind in ("traj", "posctrl"):
        r = ld["launch"][kind]
        kernels.append(entry(
            "apg_solve", f"P=1, batched B={r['labels']}: distillation labels, iris {kind}, "
            f"{r['max_iter']} iterations", ld["label_launches"][kind], r["fixed10_du"], r["ms"],
            r["fixed10_plain_ms"],
            bound(r["bundle"], "apg_solve", r["n_consts"], K=4, iters=r["iterations_mean"],
                  B=r["labels"]),
            timed=f"one label launch of {r['labels']} sampled states at the "
                  f"{r['max_iter']}-iteration budget, CUDA events",
            plain_ms_is="one label scenario's plain whole solve at a 10-iteration budget "
                        "(max_abs_err: its plan against the kernel's)",
            fixed10_ms=r["fixed10_ms"], labels_per_s=r["labels_per_s"],
            iterations_mean=r["iterations_mean"], iterations_max=r["iterations_max"],
            share_at_budget=r["at_budget"],
            label_calls=[c for c in ld["calls"] if c["kind"] == kind]))
    kernels.append(entry(
        "apg_solve", "P=1, the retrained checkpoint on its probed hover_diag metric (iris traj)",
        lp["launches"], lp["fixed_du"], lp["fixed_ms"], lp["fixed_plain_ms"],
        bound(lp["bundle"], "apg_solve", lp["n_consts"], K=4, iters=10),
        timed="fixed 10-iteration solve", chained_wall_ms_p50=lp["wall_ms_p50"],
        chained_device_ms_p50=lp["device_ms_p50"], chained_iterations_p50=lp["iterations_p50"]))
    # phase 26: the tuning sweeps on #1 (per-scenario weights), #3 and #4
    for name in TUNE_CONFIGS:
        w = tune["weights"][name]
        kernels.append(entry(
            "apg_solve", f"P=1, batched B={w['candidates']}, per-scenario tracking weights: "
            f"tune_cost_weights, {name}", w["launches"]["apg_solve"], w["fixed_du"],
            w["launch_ms"], w["plain_ms"],
            bound(w["bundle"], "apg_solve", w["n_consts"], K=4, iters=w["iterations_mean"],
                  B=w["candidates"]),
            timed=f"one launch over the {w['candidates']} candidates at the sweep's first "
                  f"period, full budget, {w['iterations_mean']:.1f} it. mean",
            plain_ms_is=f"one candidate's plain whole solve at {TUNE_PLAIN_ITERS} iterations "
                        f"(max_abs_err: its plan against the kernel's, 4 candidates)",
            ms_per_period=w["ms_per_period"], device_ms_per_period=w["device_ms_per_period"],
            solves_per_s=w["solves_per_s"], bit_equal_to_solo=w["bit_equal"],
            launches_per_period=w["launches_per_period"]))
    for name in TUNE_CONFIGS:
        m = tune["mppi"][name]
        N, K = m["candidates"], m["K"]
        kernels += [
            entry("value_batch", f"P=1, batched B={N} x K={K}: tune_mppi, {name}",
                  m["launches"]["value_batch"], m["value_batch_err"], m["value_batch_ms"],
                  m["value_batch_plain_ms"],
                  bound(m["bundle"], "value_batch", m["n_consts"], K=K, B=N),
                  timed=f"per launch over {N} x {K} plans at the sweep's first period",
                  plain_ms_is=f"one candidate's plain value_batch at K={K}",
                  max_abs_err_is="relative to the plain oracle",
                  ms_per_period=m["ms_per_period"],
                  device_ms_per_period=m["device_ms_per_period"],
                  solves_per_s=m["solves_per_s"], bit_equal_to_solo=m["bit_equal"],
                  first_period_rel=m["first_period_rel"], first_period_du=m["first_period_du"],
                  launches_per_period=m["launches_per_period"]),
            entry("trajectory", f"batched B={N}: tune_mppi's plant, {name}",
                  m["launches"]["trajectory"], m["trajectory_err"], m["trajectory_ms"],
                  m["trajectory_plain_ms"], bound(m["bundle"], "trajectory", m["n_consts"], B=N),
                  timed=f"per launch over {N} plans",
                  plain_ms_is="one plan's plain rollout (rollout_mean on the card)")]
    # phase 28: the bf16 trunk on the particle forms of #1-#3 and the P=1
    # value_batch; launches from the main path (b) and the routes (c)
    fm, fl, rt, of = bf["forms"], bf["flagship"], bf["routes"], bf["option_forms"]

    def option_fields(kind):
        fields = {f"options_P{P}_{k}": of[f"{kind}_P{P}"][f] for P in (P_FULL, P_LARGE)
                  for k, f in (("ms", "ms"), ("fp32_form_ms", "fp32_ms"),
                               ("err_by_metric", "err"), ("gap_to_fp32_form", "gap"))}
        fields["options_is"] = ("the options form's bf16 instantiation (risk_lambda 2 and "
                                "state-noise starts) against its plain bf16 twin and its fp32 "
                                f"form, P={P_FULL} and P={P_LARGE} antithetic (phase 28 (a))")
        return fields

    def bf16_entry(name, form, branch, launches, **extra):
        r = fm[form]
        return entry(name, f"bf16 trunk, {branch}", launches, max(r["err"].values()), r["ms"],
                     r["plain_ms"], r["bound"], bound_tc_ms=r["bound_tc_ms"],
                     fp32_form_ms=r["fp32_ms"], err_by_metric=r["err"],
                     gap_to_fp32_form=r["gap"],
                     max_abs_err_is="the largest of err_by_metric, against the plain bf16 "
                                    "twin (phase 28)", **extra)

    kernels += [
        bf16_entry("apg_solve", "apg_solve", f"particles, P={P_FULL} antithetic",
                   fl["default"]["bf16_launches"]["apg_solve"],
                   timed=f"fixed 5-iteration solve at P={P_FULL} antithetic with its fp32 "
                         "trajectory launch, CUDA events",
                   flagship_wall_ms_p50=fl["default"]["wall_ms_p50"],
                   flagship_device_ms_p50=fl["default"]["device_ms_p50"],
                   flagship_iterations=fl["default"]["iterations"],
                   fp32_flagship_wall_ms_p50=fl["highest"]["wall_ms_p50"],
                   fp32_flagship_device_ms_p50=fl["highest"]["device_ms_p50"],
                   fp32_flagship_iterations=fl["highest"]["iterations"],
                   uncertainty_launches=rt["uncertainty"]["bf16_launches"]["apg_solve"],
                   **option_fields("apg_solve")),
        bf16_entry("value_and_grad", "value_and_grad", f"particles, P={P_FULL} antithetic",
                   rt["fixed_step"]["bf16_launches"]["value_and_grad"], timed="per launch",
                   **option_fields("value_and_grad")),
        bf16_entry("value_batch", f"value_batch_P{P_FULL}_K1",
                   f"particles, P={P_FULL} antithetic, K=1",
                   rt["fixed_step"]["bf16_launches"]["value_batch"], timed="per launch",
                   **{f"{k}_{tag}": fm[form][f] for tag, form in (
                       ("K4", f"value_batch_P{P_FULL}_K4"),
                       (f"K{BF16_MPPI_K}xP{BF16_MPPI_P}", "value_batch_mppi"))
                      for k, f in (("ms", "ms"), ("plain_ms", "plain_ms"),
                                   ("fp32_form_ms", "fp32_ms"), ("err_by_metric", "err"))},
                   bound_ms_K4=fm[f"value_batch_P{P_FULL}_K4"]["bound"][0],
                   bound_ms_mppi_shape=fm["value_batch_mppi"]["bound"][0],
                   **option_fields("value_batch")),
        bf16_entry("value_batch", "value_batch_P1", f"P=1, register chain, K={BF16_P1_K}",
                   rt["mppi_p1"]["bf16_launches"]["value_batch"], timed="per launch",
                   policy_launches=rt["policy"]["bf16_launches"]["value_batch"],
                   **{f"shared_memory_step_{k}": fm["value_batch_P1_smem"][f] for k, f in (
                       ("ms", "ms"), ("plain_ms", "plain_ms"), ("fp32_form_ms", "fp32_ms"),
                       ("err_by_metric", "err"), ("gap_to_fp32_form", "gap"))},
                   shared_memory_step_is=f"the bf16 form on the trunk padded to {PADDED_HID} "
                                         "units, K=64 (no launch on the main path: the iris "
                                         "trunk runs the register chain)")]
    # phase 29's launches, summed over the ranks, on the rows of the forms
    # they ran (the flagship's oracle forms are its bf16 ones)
    ml = mesh["launches"]
    msum = lambda keys, kernel: sum(n[kernel] for key in keys for n in ml[key])
    for k in kernels:
        if k["name"] == "apg_solve" and k["branch"] == f"P=1, batched B={BATCH_B}":
            k["mesh_launches"] = msum(("dp", "fleet", "labels", "tuning"), "apg_solve")
            k["mesh_dp_device_ms_per_step"] = mesh["dp"]["device_ms_per_step"]
        if k["branch"].startswith(f"bf16 trunk, particles, P={P_FULL} antithetic") and \
                k["name"] in ("value_and_grad", "value_batch"):
            k["mesh_launches"] = msum(("mc",), k["name"])
            k["mesh_ms_per_iteration"] = mesh["mc"]["ms_per_iteration"]
        if k["name"] == "trajectory" and k["branch"].startswith(f"x_evol of the P={P_FULL}"):
            k["mesh_launches"] = msum(("mc",), "trajectory")
    kernels[0]["mismatch_sweep_launches"] = tune["mismatch"]["launches"]["apg_solve"]
    kernels[0]["full_sitl_stack_launches"] = sitl["stack"]["engine_launches"]["apg_solve"]
    kernels[0]["preflight_launches"] = sitl["preflight"]["launches"]["apg_solve"]
    for k in kernels:
        if k["name"] == "value_batch" and k["branch"].startswith("P=1, K=1"):
            k["distilled_shootout_launches"] = ld["launches"]["value_batch"]
        if k["name"] == "trajectory" and k["branch"] == "P=1":
            k["distilled_shootout_launches"] = ld["launches"]["trajectory"]
    # the routes' record on a line of its own, the kernels' line after it
    print(json.dumps({"record": {"solve_ms": {
        "mppi": timing["mppi"][0], "mppi_plain": timing["mppi"][1],
        "fixed_step": timing["fixed_step"][0],
        "fixed_step_plain": timing["fixed_step"][1],
        f"p{P_FULL}anti_traj": flight["wall_ms"],
        "constrained_flight_p50": statistics.median(cflight["runs"]["prox"]["wall"][1:]),
        "hexa_traj": hexa["traj"][0], "hexa_pos": hexa["pos"][0]},
        "closed_loop": {tag: {k: v for k, v in run.items() if k != "launches"}
                        for tag, run in loops.items()},
        "launch_tier": {k: v for k, v in tier.items() if k != "fcu_tail"},
        "fleet": {k: v for k, v in fleet.items() if k != "launches"},
        "policy": {"pure": {k: {f: v for f, v in r.items() if f != "launches"}
                            for k, r in policy["pure"].items()},
                   "host_split": policy["host"],
                   "hybrid": policy["hybrid"],
                   "ticks": {r: {f: v for f, v in t.items() if f != "launches"}
                             for r, t in policy["ticks"].items()},
                   "closed_loop": {r: {k: v for k, v in run.items() if k != "launches"}
                                   for r, run in policy["closed_loop"].items()}},
        "batched_routes": {key: {f: v for f, v in boracle[key].items() if f != "last"}
                           for key in ("mppi", "fixed", "policy_0", "policy_15")},
        "batched_bit_equal": boracle["bit_equal"],
        "particle_options": {
            "cases": popt["cases"], "fixed_ms": {f"P={P_FULL}": fx, f"P={P_LARGE}": fx2},
            "oracle_ms": om, "padded_value_batch": popt["padded"],
            "uncertainty": proute["uncertainty"],
            "noise_robustness": proute["noise_robustness"],
            "floor_backoff": proute["floor_backoff"], "bit_equal": proute["bit_equal"],
            "mppi": {k: v for k, v in proute["mppi"].items() if k != "bundle"}},
        "fleet_families": {tag: {k: v for k, v in run.items() if k != "launches"}
                           for tag, run in boracle["fleet"].items()},
        "learning": {
            "log": {k: v for k, v in learn["log"].items() if k != "npz"},
            "train": {k: v for k, v in learn["train"].items() if k != "ckpt"},
            "probe": {k: v for k, v in lp.items() if k != "bundle"},
            "distill": {"drive": ld["drive"], "calls": ld["calls"], "launches": ld["launches"],
                        "served": ld["served"],
                        "launch": {k: {f: v for f, v in r.items() if f != "bundle"}
                                   for k, r in ld["launch"].items()}},
            "fault7": learn["fault7"]},
        "tuning": {
            kind: {name: {k: v for k, v in r.items() if k not in ("bundle",)}
                   for name, r in tune[kind].items()} for kind in ("mppi", "weights")},
        "mismatch": {k: v for k, v in tune["mismatch"].items() if k != "launches"},
        "geometric_node": tune["geometric"], "geometric_sim": tune["geometric_sim"],
        "sitl": {"router": sitl["router"],
                 "stack": {k: v for k, v in sitl["stack"].items() if k != "router_stats"},
                 "stack_router_stats": sitl["stack"].get("router_stats"),
                 "launch": sitl["launch"], "preflight": sitl["preflight"],
                 "wall_s": sitl["wall_s"]},
        "bf16": {"flagship": fl, "routes": rt, "table": bf["table"]},
        "mesh": {k: v for k, v in mesh.items() if k != "launches"},
        "mesh_launches": mesh["launches"]}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    precond_cache.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

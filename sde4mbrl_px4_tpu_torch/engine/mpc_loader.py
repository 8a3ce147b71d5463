"""MPC factory: config file -> (reset, mpc) closures on a torch device (L5).

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/mpc_loader.py``, with the
same call-site contract (``:1-59``)::

    cfg, (reset_fn, mpc_fn), state_from_traj, bundle = \\
        load_mpc_from_cfgfile(path, convert_to_enu=True)

``device`` defaults to the card (``cuda``; without one the loader raises);
``device="cpu"`` runs every kernel's plain PyTorch version instead.

- ``cfg['_time_steps']``: per-step dt list;
- ``state_from_traj(t) -> x(13)`` (ENU) or None without ``trajectory_path``;
- ``reset_fn(x, rng, xdes) -> APGState`` warm-start initializer;
- ``mpc_fn(x, rng, opt_state, curr_t=0., xdes=None, iter_budget=None) ->
  MPCSolution(u_opt[H,n_u], opt_state', rng', x_evol[H+1,13])``, with
  ``opt_state'`` carrying the one-step-shifted warm start (H, nZ).

A ``state_constr`` block (original ``:244-255``) runs on every route, on
the kernels' constraint branches: the penalty form as extra stage-cost
terms; the proximal form (``slack_proximal: True``) widens the decision
sequence to nZ = n_u + m columns, the slack targets boxed to the state
bounds (``lb_z``/``ub_z``), warm-started at 0 clipped into that box, and
``u_opt`` is its first n_u columns.

The solver runs in NED/FRD; with ``convert_to_enu`` the ``xdes`` inputs and
the trajectory table are ENU and converted here. A solve takes one of three
routes (original ``:434-455``, ``:710-822``), each on a hand-written kernel
on a CUDA device and on its plain PyTorch version on the CPU:

- ``solver: apg`` with an ``apg_mpc.linesearch`` block: one call of
  ``ops/cuda/apg_kernel.py::apg_solve_kernel_batched``, the whole solve in
  one launch, ``x_evol`` exported by it (with particles: a second launch,
  the oracle's ``trajectory``);
- ``solver: apg`` without a linesearch block: the fixed-step
  ``solver/apg.py::apg_solve_batched`` over the cost oracle
  (``ops/cuda/cost_oracle.py::cost_oracle_batched``), ``x_evol`` from
  ``oracle.trajectory``;
- ``solver: mppi``: ``solver/mppi.py::mppi_solve`` over the cost oracle,
  ``x_evol`` from ``oracle.trajectory``;
- ``solver: policy`` (``models/policy.py``, the weights of
  ``policy.params_path``): the pure policy (``refine_iters`` 0) is one
  network pass (three fp32 matrix products), then its plan's cost
  (``init_cost = opt_cost``, the oracle's ``value``: ``value_batch`` at
  K = 1) and ``x_evol`` (``trajectory``), ``num_steps`` 0, the stepsize
  carried, ``iter_budget`` ignored (original ``:681-684``, ``:786-797``);
  the hybrid (``refine_iters`` N > 0) puts the network's plan in place of
  the warm start where ``num_steps == 0`` (a cold start) and solves on the
  APG route of its config at ``max_iter = N`` (the whole-solve kernel with
  a linesearch block; original ``:685-691``). The network runs on every
  solve and the select is on the device (the original's ``lax.cond`` skips
  it on warm solves; a host read of ``num_steps`` would wait for the solve
  in flight).

The routes are written once, over a leading batch of B scenarios
(``MPCPieces.solve``, which ``parallel/batched.py::make_batched_mpc``
serves): ``mpc_fn`` is that solve at B = 1, so a solo solve and each
scenario of a batched one take the same route and, on the card, the same
launches.

``num_particles`` P > 1 makes every route minimise the mean cost over P
Monte-Carlo paths (``antithetic`` pairs them as (z, -z)); the particles
run on the same kernels, in chunks of ``pallas_chunk`` or, without it, of
the largest divisor of P that fits a block's shared memory. The original
sends P > 128 without ``pallas_chunk`` to XLA (``:334-335``); here every P
runs on the kernels. So do the three particle options the original sends to
XLA (``:336-350``, ``:434-443``), on the particle forms of the whole solve,
``value_and_grad`` and ``value_batch``:

- ``cost_params.risk_lambda``: the mean plus ``risk_lambda`` times the std
  of the particles' discounted totals (``cost/cost.py``);
- ``initial_state_std`` (a scalar or a 13-vector, broadcast as at
  ``:471-472``): particle p starts from ``renorm_quat(x + std * z0[p])``
  (``ops/rollout.py::particle_starts``, one elementwise pass on the device
  before the launch); ``x_evol`` stays the mean rollout from ``x``;
- ``solver: mppi`` at P > 1: each round's K candidates on the solve's P
  shared paths, one particle ``value_batch`` launch of K (x B) clusters.

Both options need P > 1, as in the original (``ValueError`` otherwise).

``matmul_precision`` (original ``:314-322``; ``models/sde_model.py::
resolve_precision``'s names, ``ValueError`` for others) defaults to
``default`` above 128 particles and to ``highest`` below. The original's
TPU runs DEFAULT as bf16-input, fp32-accumulate dots, but only on the
routes it sends to XLA: its Pallas kernels always run at HIGHEST. So the
trunk runs bf16 here exactly where both hold (:func:`trunk_bf16`): the
resolved precision is DEFAULT, and the original would route the config to
XLA (P > 128 without ``pallas_chunk``, ``risk_lambda``,
``initial_state_std``, MPPI at P > 1 or K > 128, the pure policy), and then
on every route of the solve and every B (``MPCPieces.trunk_bf16``), on
the kernels' bf16 forms (the particle forms of the whole solve and the
oracle, the P=1 ``value_batch``). ``x_evol``, the ``hover_diag`` probe, the
control-to-wrench product, the policy network and the costs stay fp32, as
in the original. On the CPU DEFAULT is fp32, which is what the original's
XLA computes there (:func:`default_rounds_to_bf16`): every CPU result and
golden keeps its fp32 numbers.

``apg_mpc.precond: hover_diag`` (the APG and policy routes) loads the
diagonal metric cached for the config's content (``_precond_cache_key``:
the checkpoint's bytes, the cost and the horizon; the flagship configs ship
theirs in ``configs/models/precond/``), or on a miss probes it once on the
device (:func:`hover_diag_probe`, the original's ``:510-580``) and writes
it to the first writable cache path. APG at P=1 on the card takes only the
trunks of the P=1 kernels' register layout: any other is refused here,
when the solver is built (ROADMAP.md §3 fault 7).

The tuner's hooks (original ``:194-202``, ``:234-240``, ``:360-366``;
``tuning/tuner.py``): ``mppi_params`` replaces the config's ``mppi``
block, its continuous knobs ``sigma``, ``temperature`` and ``noise_beta``
Python floats or (B,) tensors, one value per scenario of a batched solve
(``solver/mppi.py``); ``cost_params_override`` replaces the config's
``CostParams`` (float32 on the build's device), its tracking weights
``perr``/``verr``/``qerr``/``werr`` (3,) or (B, 3), one row per scenario (``cost/cost.py``; on the card each
scenario's row of the kernels' consts, ``ops/cuda/consts.py::
batch_consts``); ``state_from_traj`` is a sampler built once outside (ENU
with ``convert_to_enu``; the reference is converted per solve, as in the
original). ``samples``, ``iters`` and every routing key stay the
config's, and so does the ``hover_diag`` metric: its cache key and a
probe on a miss read the config's cost, never the override (original
``:509-522``).

``rng`` is a ``torch.Generator`` (or None for the deterministic APG
routes, which draw nothing: at ``num_particles: 1`` it passes through
unchanged, as in the original ``:655-662``). A solve draws from it in one
call each, in this order: at P > 1 the Brownian block
(``ops/rollout.py::draw_brownian``), then with ``initial_state_std`` the
starts' ``z0`` (``draw_start_spread``, antithetic-paired as the block),
then for MPPI its exploration noise (``solver/mppi.py::draw_mppi_noise``).
In place of a generator ``rng`` may be an iterator that yields each
solve's draws, which is how tests hand in the original's own draws: a
(P, H, 13) block, or ``(noise, z0)`` with a start spread; MPPI's ``(eps,
c0)``, or ``(eps, c0, noise[, z0])`` at P > 1. ``iter_budget`` caps the APG
routes and is ignored by MPPI, as in the original (``:636-644``). Configs
outside the ported scope raise ``NotImplementedError`` naming the
ROADMAP.md item that brings them.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import MPCSolution, hover_state
from sde4mbrl_px4_tpu_torch.cost.cost import CostParams, make_cost_fn
from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy, resolve_device
from sde4mbrl_px4_tpu_torch.io.config import input_bounds_from_config, load_yaml_config
from sde4mbrl_px4_tpu_torch.models import policy as policy_mod
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params, resolve_precision
from sde4mbrl_px4_tpu_torch.models.trajectory import (
    TrajectoryTable, load_trajectory_csv, make_state_from_traj)
from sde4mbrl_px4_tpu_torch.models.vehicles import hexa_config, iris_config
from sde4mbrl_px4_tpu_torch.ops.cuda.apg_kernel import apg_solve_kernel_batched
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import P1_FMAX, P1_HID, p1_widths
from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import cost_oracle_batched
from sde4mbrl_px4_tpu_torch.ops.rollout import (
    draw_brownian, draw_start_spread, make_time_steps, particle_starts, rollout_sde)
from sde4mbrl_px4_tpu_torch.solver.apg import (
    APGConfig, APGState, CostOracle, apg_solve_batched)
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise, mppi_solve

__all__ = ["load_mpc_from_cfgfile", "MPCBundle", "MPCPieces", "ParticleShard", "build_mpc",
           "default_rounds_to_bf16", "hover_diag_probe", "make_mpc_from_config",
           "not_in_slice", "trunk_bf16"]


class MPCBundle(NamedTuple):
    """Everything behind the closures — for tests and benchmarks."""

    model: NeuralSDE
    params: Dict[str, Any]
    cost_params: CostParams
    apg_config: APGConfig
    time_steps: torch.Tensor     # (H,)
    knot_times: torch.Tensor     # (H+1,) cumulative times incl. 0
    lb: torch.Tensor             # (n_u,) input box
    ub: torch.Tensor
    num_particles: int
    state_from_traj: Optional[Callable]
    convert_to_enu: bool
    precond: Optional[torch.Tensor]   # (H, nZ) hover_diag metric or None
    device: torch.device
    lb_z: torch.Tensor           # (nZ,) decision box: lb, then the slack bounds
    ub_z: torch.Tensor


class MPCPieces(NamedTuple):
    """The per-solve pieces of the factory, each over any leading batch
    shape (none for the solo ``mpc_fn``, (B,) for ``parallel/batched.py``)."""

    reset: Callable        # (x (..., 13), rng, xdes) -> APGState, fields (...)
    targets: Callable      # xdes (..., 13) in the API frame -> the solver's (NED)
    build_ref: Callable    # (curr_t (...), xdes_ned (..., 13)) -> (..., H+1, 13)
    shift: Callable        # plans (..., H, nZ) -> the shifted warm start
    carry_t: bool          # whether the stepsize carries across solves
    chunk: int             # pallas_chunk (0: the largest divisor of P that fits)
    antithetic: bool
    # solver: policy — the network's plan (x (..., 13), x_ref (..., H+1, 13),
    # u_prev (..., n_u)) -> (..., H, n_u), else None; the hybrid's polish
    # iterations (0: the pure policy); and the hybrid's cold-start select
    # (opt_state, plan) -> the warm start, the plan where num_steps == 0
    policy_plan: Optional[Callable] = None
    refine_iters: int = 0
    cold_start: Optional[Callable] = None
    # the solve of B scenarios, every route (xs (B, 13), rngs, opt_states
    # (B, ...), curr_ts (B,), xdes (B, 13) or None, iter_budget) ->
    # MPCSolution over B; ``mpc_fn`` is its B = 1
    solve: Optional[Callable] = None
    # whether ``solve`` runs the trunk's products on bf16 operands
    # (:func:`trunk_bf16`)
    trunk_bf16: bool = False


class ParticleShard(NamedTuple):
    """This process's share of a solve's particles (``parallel/batched.py::
    make_particle_sharded_mpc``): block ``index`` of ``count`` equal blocks
    of the P particles; ``reduce(t)`` sums ``t`` over the ``count``
    processes in their order (every process gets the same bits) and
    ``broadcast(t, shape)`` hands every process block 0's ``t``."""

    index: int
    count: int
    reduce: Callable
    broadcast: Callable


def not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sde4mbrl_px4_tpu_torch yet; "
        f"ROADMAP.md §1 '{item}' brings it")


def _check_slice(cfg: Dict[str, Any]) -> None:
    """Refuse the config features this port does not implement yet, and
    the settings the original refuses: particle ones (``:336-341``,
    ``:464-470``) and ``solver: policy`` with proximal slack
    (``:374-378``)."""
    solver = str(cfg.get("solver", "apg"))
    sc = cfg.get("state_constr")
    if solver not in ("apg", "mppi", "policy"):
        raise ValueError(f"unknown solver {solver!r} (apg|mppi|policy)")
    if solver == "policy" and sc is not None and sc.get("slack_proximal"):
        # the original refuses this pairing (:374-378)
        raise ValueError(
            "solver: policy does not support slack_proximal state "
            "constraints — the policy head predicts motor plans only "
            "(distill an expert WITHOUT slack, or keep solver: apg)")
    P = int(cfg.get("num_particles", 1))
    if cfg["cost_params"].get("risk_lambda") and P <= 1:
        raise ValueError(
            "cost_params.risk_lambda needs num_particles > 1 — with one "
            "particle there is no outcome spread to price")
    if cfg.get("initial_state_std") is not None and P <= 1:
        raise ValueError(
            "initial_state_std needs num_particles > 1 — the deterministic "
            "single-particle path would ignore the scenario spread")
    chunk = int(cfg.get("pallas_chunk", 0) or 0)
    if chunk < 0 or (chunk and P % chunk):
        raise ValueError(f"pallas_chunk={chunk} must divide num_particles={P}")
    if bool(cfg.get("antithetic", False)) and P > 1 and P % 2:
        raise ValueError(f"antithetic sampling needs an even particle count, got {P}")


def default_rounds_to_bf16(device: torch.device) -> bool:
    """What the original's DEFAULT matmul precision computes on ``device``:
    on the card the TPU's bf16 inputs with fp32 sums (JAX on a GPU would
    take TF32 here; the port keeps TF32 off, ROADMAP.md §3), on the CPU fp32,
    which is what XLA's CPU backend computes for the original."""
    return torch.device(device).type == "cuda"


def _jax_routes_to_xla(cfg: Dict[str, Any], mppi_params: Optional[MPPIConfig] = None) -> bool:
    """Whether the original, on its TPU, sends this config's solve to XLA
    rather than to its Pallas kernels (``engine/mpc_loader.py:330-350``,
    ``:432-445``): P > 128 without ``pallas_chunk``, ``risk_lambda`` or
    ``initial_state_std``, MPPI at P > 1 or more than 128 samples (those of
    ``mppi_params`` where the tuner's hook gives them), and the pure policy
    (``refine_iters`` 0)."""
    P = int(cfg.get("num_particles", 1))
    solver = str(cfg.get("solver", "apg"))
    if P > 128 and not int(cfg.get("pallas_chunk", 0) or 0):
        return True
    if cfg["cost_params"].get("risk_lambda") or cfg.get("initial_state_std") is not None:
        return True
    if solver == "mppi":
        mp = MPPIConfig.from_config(cfg) if mppi_params is None else mppi_params
        return P > 1 or int(mp.samples) > 128
    return solver == "policy" and not int((cfg.get("policy") or {}).get("refine_iters", 0)
                                          or 0)


def trunk_bf16(cfg: Dict[str, Any], device: torch.device,
               mppi_params: Optional[MPPIConfig] = None) -> bool:
    """Whether the solves of ``cfg`` on ``device`` run the trunk's products
    on bf16 operands: the resolved ``matmul_precision`` (``default`` above
    128 particles, as in the original ``:320-322``) is DEFAULT, the original
    routes the config to XLA (:func:`_jax_routes_to_xla`), and DEFAULT rounds
    on ``device`` (:func:`default_rounds_to_bf16`). Unknown names raise
    ``ValueError``, as in the original, on every device."""
    P = int(cfg.get("num_particles", 1))
    default = resolve_precision(cfg.get("matmul_precision",
                                        "default" if P > 128 else "highest"))
    return default and _jax_routes_to_xla(cfg, mppi_params) and default_rounds_to_bf16(device)


def _resolve_model(cfg: Dict[str, Any], device: torch.device):
    n_u = len(cfg["input_constr"]["input_id"])
    vehicle = iris_config() if n_u == 4 else hexa_config()
    model = NeuralSDE.for_vehicle(vehicle, device)
    ckpt = cfg.get("learned_model_params")
    if ckpt and os.path.exists(os.path.expanduser(ckpt)):
        tree, meta = load_params(ckpt)
        if meta.get("vehicle") not in (None, vehicle.name):
            warnings.warn(f"checkpoint vehicle {meta.get('vehicle')!r} != "
                          f"config vehicle {vehicle.name!r}")
        return model, params_from_numpy(tree, device)
    if ckpt:
        warnings.warn(f"learned_model_params {ckpt!r} not found; "
                      "initializing fresh physics-prior model")
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return model, init_params(gen, model, device=device)


def _check_p1_trunk(params: Dict[str, Any], n_u: int) -> None:
    """ROADMAP.md §3 fault 7, refused when the solver is built rather than
    at its first launch: the P=1 whole solve and ``value_and_grad`` on the
    card hold the trunk in registers (``ops/cuda/consts.py::p1_widths``),
    so APG at P=1 takes no other trunk there."""
    F, HID = (int(v) for v in params["net"]["w0"].shape)
    if not p1_widths(F, HID):
        raise ValueError(
            f"fault 7 (ROADMAP.md §3): this checkpoint's trunk has {HID} hidden units and "
            f"{F} inputs, and APG at num_particles 1 on the card takes only {P1_HID} "
            f"hidden units and at most {P1_FMAX} inputs (the P=1 kernels hold the trunk "
            f"in registers); ROADMAP.md §1 item 21 brings a shared-memory P=1 form. Until "
            f"then fly it with device='cpu', num_particles > 1, solver: mppi or a pure "
            f"policy")


def _resolve_policy(cfg: Dict[str, Any], H: int, n_u: int, lb_np: np.ndarray,
                    ub_np: np.ndarray, device: torch.device
                    ) -> Tuple[policy_mod.PolicyNet, int]:
    """The ``policy`` block (original ``:380-431``): ``(network,
    refine_iters)``. A configured ``params_path`` must exist and hold an
    MPC policy checkpoint of the config's horizon and motors; without one
    the untrained init is drawn from ``cfg["seed"]`` at ``policy.hidden``
    widths (the numbers differ from the original's threefry draws)."""
    blk = cfg.get("policy") or {}
    path = blk.get("params_path")
    if path and os.path.exists(os.path.expanduser(path)):
        tree, meta = load_params(path)
        if meta.get("kind") not in (None, policy_mod.POLICY_KIND):
            raise ValueError(f"policy.params_path {path!r} is not an MPC policy "
                             f"checkpoint (meta {meta!r})")
        net = policy_mod.policy_from_numpy(tree, device)
        if (net.H, net.n_u) != (H, n_u):
            raise ValueError(f"policy checkpoint horizon/motors ({net.H}, {net.n_u}) "
                             f"!= config ({H}, {n_u})")
    elif path:
        raise ValueError(
            f"policy.params_path {path!r} does not exist — refusing to serve an "
            "untrained hover policy in its place; drop params_path to ask for an "
            "untrained init explicitly")
    else:
        uref = np.broadcast_to(np.asarray(cfg["cost_params"]["uref"], np.float32), (n_u,))
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        net = policy_mod.init_policy(gen, H, n_u, lb_np, ub_np, uref,
                                     hidden=tuple(blk.get("hidden", (256, 256))),
                                     device=device)
    refine = int(blk.get("refine_iters", 0) or 0)
    if refine < 0:
        raise ValueError(f"policy.refine_iters must be >= 0, got {refine}")
    return net, refine


# ---- copied from sde4mbrl_px4_tpu/engine/mpc_loader.py:126-176 ------------
# (bit-identical: the port loads the committed hover_diag artifacts the JAX
# package wrote, configs/models/precond/*.npy)

_PRECOND_VERSION = "hover_diag-v1"


def _precond_cache_paths(cfg: Dict[str, Any], key: str) -> list:
    """Candidate cache files for a precomputed preconditioner, most
    preferred first: next to the model checkpoint (ships as a committed
    artifact with the flagship configs), else a per-user cache dir."""
    cands = []
    env = os.environ.get("SDE4MBRL_PRECOND_CACHE")
    if env:
        cands.append(os.path.join(env, f"{key}.npy"))
    ckpt = cfg.get("learned_model_params")
    if ckpt:
        ckpt = os.path.expanduser(ckpt)
        if os.path.exists(ckpt):
            cands.append(os.path.join(os.path.dirname(ckpt), "precond",
                                      f"{key}.npy"))
    cands.append(os.path.join(os.path.expanduser("~"), ".cache",
                              "sde4mbrl_px4_tpu", "precond", f"{key}.npy"))
    return cands


def _precond_cache_key(cfg: Dict[str, Any], vehicle_name: str,
                       time_steps_np: np.ndarray, lb_np: np.ndarray,
                       ub_np: np.ndarray, nZ: int,
                       convert_to_enu: bool) -> str:
    """Content hash of every input the hover_diag probe depends on: the
    checkpoint bytes (or the fresh-init tag), the cost/constraint config,
    the horizon schedule, the input box, and the trajectory table bytes.
    Formula changes bump ``_PRECOND_VERSION``."""
    h = hashlib.sha256()
    h.update(_PRECOND_VERSION.encode())
    ckpt = os.path.expanduser(cfg.get("learned_model_params") or "")
    if ckpt and os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            h.update(f.read())
    else:
        h.update(f"fresh:{vehicle_name}".encode())
    # "discount" weights every stage of the probe's cost (cost/cost.py
    # reads the top-level key) — it must invalidate like the weight dicts.
    for k in ("cost_params", "state_constr", "input_constr", "discount"):
        h.update(json.dumps(cfg.get(k), sort_keys=True, default=str).encode())
    h.update(np.asarray(time_steps_np, np.float64).tobytes())
    h.update(np.asarray(lb_np).tobytes())
    h.update(np.asarray(ub_np).tobytes())
    h.update(f"nZ={nZ};enu={bool(convert_to_enu)}".encode())
    traj = os.path.expanduser(cfg.get("trajectory_path") or "")
    if traj and os.path.exists(traj):
        with open(traj, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:24]

# ---------------------------------------------------------------------------


def hover_diag_probe(model: NeuralSDE, params: Dict[str, Any], cost_params: CostParams,
                     time_steps: torch.Tensor, x_ref: torch.Tensor,
                     z_hover: torch.Tensor) -> np.ndarray:
    """The ``hover_diag`` metric (original ``:533-568``): the diagonal of the
    Hessian of the deterministic P=1 rollout cost at the hover plan
    ``z_hover`` (H, nZ), from x = ``x_ref[0]`` with ``u_prev`` the hover
    command, floored at 1e-4 of its peak, returned as ``min(d) / d`` in
    float32 (so its largest entry is 1). One HVP per decision entry
    (``torch.func``: forward over reverse, vmapped over the H·nZ basis) on
    the plain rollout and cost, on ``z_hover``'s device."""
    H, nZ = z_hover.shape
    n_u = model.n_u
    cost_fn = make_cost_fn(cost_params, time_steps)
    x_p, u_prev = x_ref[0], z_hover[0, :n_u]
    noise = torch.zeros(H, 1, 13, dtype=torch.float32, device=z_hover.device)

    def cost(z):
        u_seq = z[:, :n_u]
        x_paths, sigmas = rollout_sde(model, params, x_p, u_seq, time_steps, noise)
        return cost_fn(x_paths, sigmas, u_seq, x_ref, u_prev,
                       s_seq=z[:, n_u:] if nZ > n_u else None)

    grad = torch.func.grad(cost)

    def hess_diag(e):
        return torch.sum(torch.func.jvp(grad, (z_hover,), (e,))[1] * e)

    basis = torch.eye(H * nZ, dtype=torch.float32, device=z_hover.device).reshape(-1, H, nZ)
    d = torch.func.vmap(hess_diag)(basis).reshape(H, nZ)
    # strictly positive: a (near-)flat or locally concave direction cannot
    # blow the step up
    d = torch.maximum(d, 1e-4 * torch.max(d))
    return (torch.min(d) / d).to(torch.float32).cpu().numpy()


def _load_precond(cfg, model, params, cost_params, time_steps, x_ref, z_hover,
                  lb_np, ub_np, convert_to_enu) -> torch.Tensor:
    """The cached ``hover_diag`` metric of this config's content (original
    ``:510-570``), else :func:`hover_diag_probe` at ``x_ref`` (H+1, 13) and
    ``z_hover`` (H, nZ), written atomically to the first writable cache
    path."""
    H, nZ = z_hover.shape
    time_steps_np = time_steps.cpu().numpy()
    key = _precond_cache_key(cfg, model.vehicle.name, time_steps_np, lb_np,
                             ub_np, nZ, convert_to_enu)
    cands = _precond_cache_paths(cfg, key)
    for cand in cands:
        if os.path.exists(cand):
            try:
                d = np.load(cand)
            except (OSError, ValueError, EOFError):     # a corrupt cache: probe below
                continue
            if d.shape == (H, nZ):
                return torch.tensor(np.asarray(d, np.float32), device=z_hover.device)
    d = hover_diag_probe(model, params, cost_params, time_steps, x_ref, z_hover)
    for cand in cands:
        try:
            os.makedirs(os.path.dirname(cand), exist_ok=True)
            tmp = f"{cand}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, d)
            os.replace(tmp, cand)
            break
        except OSError:
            continue                # a read-only location: the next one
    return torch.tensor(d, device=z_hover.device)


def build_mpc(cfg: Dict[str, Any], convert_to_enu: bool = True,
              device: Optional[torch.device | str] = None,
              mppi_params: Optional[MPPIConfig] = None,
              state_from_traj: Optional[Callable] = None,
              cost_params_override: Optional[CostParams] = None,
              shard: Tuple[int, int] = (0, 1),
              particle_shard: Optional[ParticleShard] = None
              ) -> Tuple[Dict[str, Any], MPCBundle, MPCPieces]:
    """What :func:`make_mpc_from_config` builds its closures from: the
    checked config (with ``_time_steps``), the bundle and the per-solve
    pieces. ``device=None`` is the card (``cuda``); without one this
    raises. The tuner's hooks are the module docstring's.

    The mesh's hooks (``parallel/``): ``shard`` ``(index, count)`` makes a
    solve of B scenarios the rows ``index * B`` to ``(index + 1) * B`` of a
    batch of ``count * B``: its draws are that batch's (a generator draws
    them all, an iterator hands them all), and it keeps its rows, so a
    scenario's draws do not depend on the mesh. ``particle_shard`` makes
    every evaluation of a solve this process's share of the particles,
    summed over the processes (:class:`ParticleShard`): the linesearch
    route then runs the host loop (``solver/apg.py::apg_solve_batched``)
    over that oracle in place of the whole-solve kernel, and ``x_evol``
    is block 0's ``trajectory``."""
    _check_slice(cfg)
    apply_fp32_policy()
    dev = resolve_device(device)
    bf16 = trunk_bf16(cfg, dev, mppi_params)
    model, params = _resolve_model(cfg, dev)
    n_u = model.n_u
    f32 = torch.float32

    time_steps_np = make_time_steps(cfg["horizon"], cfg["num_short_dt"],
                                    cfg["short_step_dt"], cfg["long_step_dt"])
    cfg["_time_steps"] = [float(d) for d in time_steps_np]
    H = len(time_steps_np)
    time_steps = torch.tensor(time_steps_np, device=dev)
    knot_times = torch.tensor(np.concatenate(
        [np.zeros(1, np.float32), np.cumsum(time_steps_np.astype(np.float32))]),
        device=dev)
    lb_np, ub_np = input_bounds_from_config(cfg)
    lb, ub = torch.tensor(lb_np, device=dev), torch.tensor(ub_np, device=dev)
    cfg_cost = CostParams.from_config(cfg, n_u, device=dev)
    cost_params = cfg_cost if cost_params_override is None else cost_params_override
    m = cost_params.n_slack
    nZ = n_u + m
    if m:
        lb_z = torch.cat([lb, cost_params.slack_lo])
        ub_z = torch.cat([ub, cost_params.slack_hi])
        # admissible slack targets at rest: 0 clipped into the state box
        # (original :480-490)
        s_hover = torch.clamp(torch.zeros_like(cost_params.slack_lo),
                              cost_params.slack_lo, cost_params.slack_hi)
    else:
        lb_z, ub_z = lb, ub
    apg_cfg = APGConfig.from_config(cfg)
    solver = str(cfg.get("solver", "apg"))
    policy_net, refine = None, 0
    if solver == "policy":
        policy_net, refine = _resolve_policy(cfg, H, n_u, lb_np, ub_np, dev)
        if refine:
            # the hybrid's polish: refine_iters iterations (original :428-431)
            apg_cfg = apg_cfg._replace(max_iter=refine, max_no_improvement_iter=refine)
    num_particles = int(cfg.get("num_particles", 1))
    antithetic = bool(cfg.get("antithetic", False))
    if dev.type == "cuda" and num_particles == 1 and (solver == "apg" or refine):
        _check_p1_trunk(params, n_u)
    # the particles' start spread (original :463-472): a scalar or 13 stds
    init_std = cfg.get("initial_state_std")
    x0_spread = None if init_std is None else torch.tensor(
        np.broadcast_to(np.asarray(init_std, np.float32), (13,)).copy(), device=dev)
    chunk = int(cfg.get("pallas_chunk", 0) or 0)
    warm_shift = str(cfg.get("warm_shift", "repeat"))

    state_from_traj_ned = None
    if state_from_traj is None and cfg.get("trajectory_path"):
        table = load_trajectory_csv(cfg["trajectory_path"], convert_to_ned=False)
        state_from_traj = make_state_from_traj(table, dev)
        if convert_to_enu:
            # NED twin of the knots, built once: lerp in NED equals lerp in
            # ENU then convert (original :269-293).
            states_ned = enu2ned(torch.from_numpy(table.states)).numpy()
            state_from_traj_ned = make_state_from_traj(
                TrajectoryTable(times=table.times, states=states_ned), dev)

    precond_mode = str(cfg["apg_mpc"].get("precond") or "none")
    if precond_mode not in ("none", "hover_diag"):
        raise ValueError(f"apg_mpc.precond must be 'hover_diag' or omitted, "
                         f"got {precond_mode!r}")
    # MPPI takes no metric: the original loads it for apg and policy (:509)
    precond = None
    if precond_mode == "hover_diag" and solver in ("apg", "policy"):
        # the probe's point (original :488-490, :537-544): the trajectory's
        # first knots (or hover), the hover plan with the slack columns at
        # their rest targets
        if state_from_traj is not None:
            x_ref_p = state_from_traj(knot_times)
            x_ref_p = enu2ned(x_ref_p) if convert_to_enu else x_ref_p
        else:
            x_ref_p = hover_state(dev).expand(H + 1, 13)
        z_hover = cost_params.uref.expand(H, n_u)
        if m:
            z_hover = torch.cat([z_hover, s_hover.expand(H, m)], dim=-1)
        precond = _load_precond(cfg, model, params, cfg_cost, time_steps, x_ref_p,
                                z_hover.contiguous(), lb_np, ub_np, convert_to_enu)

    bundle = MPCBundle(
        model=model, params=params, cost_params=cost_params,
        apg_config=apg_cfg, time_steps=time_steps, knot_times=knot_times,
        lb=lb, ub=ub, num_particles=num_particles,
        state_from_traj=state_from_traj, convert_to_enu=convert_to_enu,
        precond=precond, device=dev, lb_z=lb_z, ub_z=ub_z)

    def reset_fn(x, rng, xdes) -> APGState:
        """State-aware warm start (original :582-615): collective thrust
        scaled by 1/cos(tilt) plus a vertical-rate damping term; slack
        columns at their rest targets. ``x`` (..., 13)."""
        del rng, xdes
        x = torch.as_tensor(x, dtype=f32, device=dev)
        lead = x.shape[:-1]
        qx, qy = x[..., 7], x[..., 8]
        cos_tilt = 1.0 - 2.0 * (qx * qx + qy * qy)
        scale = 1.0 / torch.clamp(cos_tilt, min=0.5) + 0.3 * x[..., 5]
        u0 = torch.clamp(cost_params.uref * torch.clamp(scale, 0.7, 1.5)[..., None], lb, ub)
        yk = u0[..., None, :].expand(*lead, H, n_u)
        if m:
            yk = torch.cat([yk, s_hover.expand(*lead, H, m)], dim=-1)
        z = torch.zeros(lead, dtype=f32, device=dev)
        return APGState(
            yk=yk.contiguous(), num_steps=z,
            stepsize=torch.full(lead, apg_cfg.init_stepsize, dtype=f32, device=dev),
            avg_stepsize=z, avg_linesearch=z, grad_sqr=z, init_cost=z, opt_cost=z)

    def _targets(xdes: torch.Tensor) -> torch.Tensor:
        """Targets in the solver frame: position-hold configs take ENU."""
        return enu2ned(xdes) if convert_to_enu and state_from_traj is None else xdes

    def _build_ref(curr_t: torch.Tensor, xdes: torch.Tensor) -> torch.Tensor:
        """Per-stage reference states (..., H+1, 13) in the solver frame
        (NED), for times ``curr_t`` (...)."""
        if state_from_traj is not None:
            if state_from_traj_ned is not None:
                return state_from_traj_ned(curr_t[..., None] + knot_times)
            ref = state_from_traj(curr_t[..., None] + knot_times)
            # a sampler handed in: converted per solve (original :619-625)
            return enu2ned(ref) if convert_to_enu else ref
        return xdes[..., None, :].expand(*xdes.shape[:-1], H + 1, 13)

    def _shift(z_opt: torch.Tensor) -> torch.Tensor:
        if warm_shift == "extrapolate":
            tail = torch.clamp(2.0 * z_opt[..., -1:, :] - z_opt[..., -2:-1, :], lb_z, ub_z)
        else:
            tail = z_opt[..., -1:, :]
        return torch.cat([z_opt[..., 1:, :], tail], dim=-2)

    policy_plan = cold_start = None
    if policy_net is not None:
        def policy_plan(x, x_ref, u_prev):
            """The network's plan (original :681-684): one pass over any
            leading batch, inside the input box."""
            return policy_mod.policy_apply(
                policy_net, policy_mod.featurize(x, x_ref, u_prev), lb, ub)

        def cold_start(opt_state: APGState, plan: torch.Tensor) -> torch.Tensor:
            """The hybrid's warm start: the network's plan where the solver
            is cold (``num_steps == 0``, straight after reset), else the
            shifted previous plan (original :685-691; a select, as JAX's
            vmap makes of its lax.cond)."""
            cold = (opt_state.num_steps == 0)[..., None, None]
            return torch.where(cold, plan, opt_state.yk)

    # Stepsize carry only where the trial rule can re-grow a step
    # (original :702-708).
    carry_t = apg_cfg.reset_option in ("increase", "bb")
    mppi = solver == "mppi"
    mppi_cfg = None
    if mppi:
        mppi_cfg = MPPIConfig.from_config(cfg) if mppi_params is None else mppi_params
    P = num_particles
    spread = x0_spread is not None          # needs P > 1 (_check_slice)
    P_local, lo = P, 0
    if particle_shard is not None:
        n_sh = int(particle_shard.count)
        if P % n_sh:
            raise ValueError(f"num_particles={P} must divide over the mc axis ({n_sh})")
        P_local = P // n_sh
        if P > 1 and P_local < 2:
            # a block of one particle would run as the mean dynamics
            # (cost_oracle.py::resolve_particles), not as one sampled path
            raise ValueError(f"num_particles={P} over an mc axis of {n_sh} leaves each block "
                             f"{P_local} particle; a block needs 2 or more")
        lo = int(particle_shard.index) * P_local
        if n_sh > 1 and cost_params.risk_lambda:
            # the risk term needs the global moments of the particles'
            # totals before the gradient pass, which per-block means lack
            raise not_in_slice("cost_params.risk_lambda over a sharded particle axis (mc > 1)",
                               "34. Risk under particle sharding")
        if chunk and P_local % chunk:
            raise ValueError(f"pallas_chunk={chunk} must divide the {P_local} particles of "
                             f"each of the mc axis's {n_sh} blocks")
    row_i, n_rows = (int(v) for v in shard)

    def draws(rngs, B: int):
        """The call's draws on the device, ``(noise (B, P, H, 13), z0 (B, P,
        13), eps, c0)``, each None where the solve takes none: from a
        generator in the module docstring's order (the block one draw of
        (B, H, P, 13), its view transposed), or the next item an iterator
        hands in (the module docstring's forms)."""
        if not (P > 1 or mppi):
            return None, None, None, None
        out = _global_draws(rngs, B * n_rows)
        if n_rows > 1:
            rows = slice(row_i * B, (row_i + 1) * B)
            out = tuple(None if d is None else d[rows] for d in out)
        return out

    def _global_draws(rngs, B: int):
        if isinstance(rngs, torch.Generator):
            noise = z0 = eps = c0 = None
            if P > 1:
                noise = draw_brownian(rngs, B * H, P, antithetic, dev)
                noise = noise.reshape(B, H, P, 13).transpose(1, 2)
            if spread:
                z0 = draw_start_spread(rngs, P, antithetic, dev, batch=(B,))
            if mppi:
                eps, c0 = draw_mppi_noise(rngs, mppi_cfg, H, nZ, dev, batch=(B,))
            return noise, z0, eps, c0
        if rngs is None:
            raise ValueError(f"{'solver: mppi' if mppi else 'num_particles > 1'} needs rng: "
                             "a torch.Generator or an iterator of draws")
        item = next(rngs)
        item = list(item) if isinstance(item, tuple) else [item]
        eps, c0 = (item.pop(0), item.pop(0)) if mppi else (None, None)
        noise = item.pop(0) if P > 1 else None
        z0 = item.pop(0) if spread else None
        if item:
            raise ValueError(f"rng: a solve's draws hold {len(item)} item(s) more than "
                             "the config takes")
        return tuple(None if d is None else d.to(dev, f32) for d in (noise, z0, eps, c0))

    def solve(xs, rngs, opt_states: APGState, curr_ts, xdes=None,
              iter_budget: Optional[int] = None) -> MPCSolution:
        """B solves, each evaluation one launch over them (the module
        docstring's routes); ``xdes`` (B, 13) in the config's frame (None:
        hold ``xs``), ``curr_ts`` (B,) the scenarios' times on the
        trajectory."""
        xs = torch.as_tensor(xs, dtype=f32, device=dev)
        B = int(xs.shape[0])
        xdes = xs if xdes is None else torch.as_tensor(xdes, dtype=f32, device=dev)
        curr_ts = torch.as_tensor(curr_ts, dtype=f32, device=dev)
        x_ref = _build_ref(curr_ts, _targets(xdes))
        u_prev = opt_states.yk[:, 0]
        noise, z0, eps, c0 = draws(rngs, B)
        # the particles' starts (B, P, 13), one elementwise pass on the device
        starts = None if z0 is None else particle_starts(xs, x0_spread, z0).contiguous()
        yk = opt_states.yk
        if solver == "policy":
            # u_prev is the previously commanded control, read above
            plan = policy_plan(xs, x_ref, u_prev[:, :n_u])
            if not refine:
                # one network pass is the solve (original :786-797): the
                # plan's cost is telemetry (init_cost = opt_cost)
                orc = oracle(xs, x_ref, u_prev, noise, starts)
                with torch.no_grad():
                    c, x_evol = orc.value(plan), orc.trajectory(plan)
                z = torch.zeros(B, dtype=f32, device=dev)
                st = APGState(yk=plan, num_steps=z, stepsize=opt_states.stepsize,
                              avg_stepsize=z, avg_linesearch=z, grad_sqr=z, init_cost=c,
                              opt_cost=c)
                return MPCSolution(u_opt=plan, opt_state=st._replace(yk=_shift(plan)),
                                   rng=rngs, x_evol=x_evol)
            yk = cold_start(opt_states, plan)
        if not mppi and apg_cfg.use_linesearch and particle_shard is None:
            st, x_evol = apg_solve_kernel_batched(
                model, params, cost_params, apg_cfg, time_steps, xs, x_ref, u_prev, noise,
                P, lb_z, ub_z, yk, t_init=opt_states.stepsize if carry_t else None,
                precond=precond, iter_budget=iter_budget, chunk=chunk, starts=starts,
                bf16=bf16)
        else:
            orc = oracle(xs, x_ref, u_prev, noise, starts)
            with torch.no_grad():
                if mppi:
                    st = mppi_solve(orc, yk, lb_z, ub_z, mppi_cfg, eps, c0)
                else:
                    st = apg_solve_batched(orc, yk, lb_z, ub_z, apg_cfg,
                                           t_init=opt_states.stepsize if carry_t else None,
                                           precond=precond, iter_budget=iter_budget)
                x_evol = orc.trajectory(st.yk)
        return MPCSolution(u_opt=st.yk[..., :n_u], opt_state=st._replace(yk=_shift(st.yk)),
                           rng=rngs, x_evol=x_evol)

    def oracle(xs, x_ref, u_prev, noise, starts):
        if particle_shard is None:
            return cost_oracle_batched(model, params, cost_params, time_steps, xs, x_ref,
                                       u_prev, noise, P, apg_cfg.maxls, chunk=chunk,
                                       starts=starts, bf16=bf16)
        return _sharded_oracle(xs, x_ref, u_prev, noise, starts)

    def _sharded_oracle(xs, x_ref, u_prev, noise, starts):
        """This process's particles ``lo .. lo + P_local`` (noise and starts
        sliced alike), every evaluation its partial mean summed over the
        processes in their order and divided by their count (a mean of
        equal blocks' means); ``trajectory`` block 0's."""
        hi = lo + P_local
        local = cost_oracle_batched(
            model, params, cost_params, time_steps, xs, x_ref, u_prev,
            None if noise is None else noise[:, lo:hi], P_local, apg_cfg.maxls, chunk=chunk,
            starts=None if starts is None else starts[:, lo:hi].contiguous(), bf16=bf16)
        n_sh = float(particle_shard.count)
        mean = lambda t: particle_shard.reduce(t) / n_sh

        def value_batch(U):
            return mean(local.value_batch(U))

        def value_and_grad(u):
            f, g = local.value_and_grad(u)
            fg = mean(torch.cat([f.reshape(-1), g.reshape(-1)]))
            return fg[:f.numel()].reshape(f.shape), fg[f.numel():].reshape(g.shape)

        def trajectory(u):
            B = int(u.shape[0])
            mine = local.trajectory(u) if particle_shard.index == 0 else None
            return particle_shard.broadcast(mine, (B, H + 1, 13))

        return CostOracle(value=lambda u: value_batch(u[:, None])[:, 0],
                          value_batch=value_batch, value_and_grad=value_and_grad,
                          trajectory=trajectory)

    pieces = MPCPieces(reset=reset_fn, targets=_targets, build_ref=_build_ref, shift=_shift,
                       carry_t=carry_t, chunk=chunk, antithetic=antithetic,
                       policy_plan=policy_plan, refine_iters=refine, cold_start=cold_start,
                       solve=solve, trunk_bf16=bf16)
    return cfg, bundle, pieces


def make_mpc_from_config(cfg: Dict[str, Any], convert_to_enu: bool = True,
                         device: Optional[torch.device | str] = None,
                         mppi_params: Optional[MPPIConfig] = None,
                         state_from_traj: Optional[Callable] = None,
                         cost_params_override: Optional[CostParams] = None
                         ) -> Tuple[Dict[str, Any], Tuple[Callable, Callable],
                                    Optional[Callable], MPCBundle]:
    """Core factory; ``cfg`` is an already-parsed config mapping.
    ``device=None`` is the card (``cuda``); without one this raises, and
    ``"cpu"`` must be asked for. ``mppi_params``, ``state_from_traj`` and
    ``cost_params_override`` are the tuner's hooks (module docstring); the
    solo ``mpc_fn`` takes their scalar forms."""
    cfg, bundle, pieces = build_mpc(cfg, convert_to_enu, device, mppi_params,
                                    state_from_traj, cost_params_override)
    dev, f32 = bundle.device, torch.float32

    def mpc_fn(x, rng, opt_state: APGState, curr_t=0.0, xdes=None,
               iter_budget: Optional[int] = None) -> MPCSolution:
        x = torch.as_tensor(x, dtype=f32, device=dev)[None]
        xdes = None if xdes is None else torch.as_tensor(xdes, dtype=f32, device=dev)[None]
        curr_t = torch.as_tensor(curr_t, dtype=f32, device=dev).reshape(1)
        draws = rng if rng is None or isinstance(rng, torch.Generator) else map(_one, rng)
        sol = pieces.solve(x, draws, APGState(*(f[None] for f in opt_state)), curr_t, xdes,
                           iter_budget)
        return MPCSolution(u_opt=sol.u_opt[0], opt_state=APGState(*(f[0] for f in sol.opt_state)),
                           rng=rng, x_evol=sol.x_evol[0])

    return cfg, (pieces.reset, mpc_fn), bundle.state_from_traj, bundle


def _one(draw):
    """A solo solve's draws (a Brownian block, or a tuple of the module
    docstring's forms) as the draws of a batch of one."""
    if isinstance(draw, tuple):
        return tuple(None if d is None else d[None] for d in draw)
    return draw[None]


def load_mpc_from_cfgfile(path: str, convert_to_enu: bool = True,
                          device: Optional[torch.device | str] = None):
    """File-path entry point (the original's ``load_mpc_from_cfgfile``);
    ``device=None`` is the card."""
    return make_mpc_from_config(load_yaml_config(path),
                                convert_to_enu=convert_to_enu, device=device)

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
  ``ops/cuda/apg_kernel.py::apg_solve_kernel``, the whole solve in one
  launch, ``x_evol`` exported by it (with particles: a second launch, the
  oracle's ``trajectory``);
- ``solver: apg`` without a linesearch block: the fixed-step
  ``solver/apg.py::apg_solve`` over the cost oracle
  (``ops/cuda/cost_oracle.py``), ``x_evol`` from ``oracle.trajectory``;
- ``solver: mppi``: ``solver/mppi.py::mppi_solve`` over the cost oracle,
  ``x_evol`` from ``oracle.trajectory``.

``num_particles`` P > 1 makes the APG routes minimise the mean cost over P
Monte-Carlo paths (``antithetic`` pairs them as (z, -z)); the particles
run on the same kernels, in chunks of ``pallas_chunk`` or, without it, of
the largest divisor of P that fits a block's shared memory. The original
sends P > 128 without ``pallas_chunk`` to XLA (``:334-335``); here every P
runs on the kernels.

``rng`` is a ``torch.Generator`` (or None for the deterministic APG
routes, which draw nothing: at ``num_particles: 1`` it passes through
unchanged, as in the original ``:655-662``). A Monte-Carlo solve draws its
Brownian block from it in one call (``ops/rollout.py::draw_brownian``),
MPPI its exploration noise (``solver/mppi.py::draw_mppi_noise``). In place
of a generator ``rng`` may be an iterator that yields each solve's draws,
a (P, H, 13) block or MPPI's ``(eps, c0)``, which is how tests hand in the
original's own draws. ``iter_budget`` caps the APG routes and is ignored by
MPPI, as in the original (``:636-644``). Configs outside the ported scope
raise ``NotImplementedError`` naming the ROADMAP.md item that brings them.
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
from sde4mbrl_px4_tpu_torch.core.types import MPCSolution
from sde4mbrl_px4_tpu_torch.cost.cost import CostParams
from sde4mbrl_px4_tpu_torch.device import apply_fp32_policy, resolve_device
from sde4mbrl_px4_tpu_torch.io.config import input_bounds_from_config, load_yaml_config
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE, init_params
from sde4mbrl_px4_tpu_torch.models.trajectory import (
    TrajectoryTable, load_trajectory_csv, make_state_from_traj)
from sde4mbrl_px4_tpu_torch.models.vehicles import hexa_config, iris_config
from sde4mbrl_px4_tpu_torch.ops.cuda.apg_kernel import apg_solve_kernel
from sde4mbrl_px4_tpu_torch.ops.cuda.cost_oracle import cost_oracle
from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian, make_time_steps
from sde4mbrl_px4_tpu_torch.solver.apg import APGConfig, APGState, apg_solve
from sde4mbrl_px4_tpu_torch.solver.mppi import MPPIConfig, draw_mppi_noise, mppi_solve

__all__ = ["load_mpc_from_cfgfile", "MPCBundle", "make_mpc_from_config"]


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


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sde4mbrl_px4_tpu_torch yet; "
        f"ROADMAP.md §1 '{item}' brings it")


# the config options of the original's particle axis that run no TPU
# kernel there (it sends them to XLA, :336-350, :434-443)
_PARTICLE_XLA = "Particles without a kernel: risk, start spread, MPPI K x P"


def _check_slice(cfg: Dict[str, Any]) -> None:
    """Refuse the config features this port does not implement yet, and
    the settings the original refuses: particle ones (``:336-341``,
    ``:464-470``) and ``solver: policy`` with proximal slack
    (``:374-378``)."""
    solver = str(cfg.get("solver", "apg"))
    sc = cfg.get("state_constr")
    if solver == "policy":
        if sc is not None and sc.get("slack_proximal"):
            # the original refuses this pairing (:374-378)
            raise ValueError(
                "solver: policy does not support slack_proximal state "
                "constraints — the policy head predicts motor plans only "
                "(distill an expert WITHOUT slack, or keep solver: apg)")
        raise _not_in_slice("solver: policy", "Policy solver family")
    if solver not in ("apg", "mppi"):
        raise ValueError(f"unknown solver {solver!r} (apg|mppi|policy)")
    P = int(cfg.get("num_particles", 1))
    if cfg["cost_params"].get("risk_lambda"):
        if P <= 1:
            raise ValueError(
                "cost_params.risk_lambda needs num_particles > 1 — with one "
                "particle there is no outcome spread to price")
        raise _not_in_slice("cost_params.risk_lambda", _PARTICLE_XLA)
    if cfg.get("initial_state_std") is not None:
        if P <= 1:
            raise ValueError(
                "initial_state_std needs num_particles > 1 — the deterministic "
                "single-particle path would ignore the scenario spread")
        raise _not_in_slice("initial_state_std", _PARTICLE_XLA)
    if solver == "mppi" and P > 1:
        raise _not_in_slice("solver: mppi with num_particles > 1", _PARTICLE_XLA)
    chunk = int(cfg.get("pallas_chunk", 0) or 0)
    if chunk < 0 or (chunk and P % chunk):
        raise ValueError(f"pallas_chunk={chunk} must divide num_particles={P}")
    if bool(cfg.get("antithetic", False)) and P > 1 and P % 2:
        raise ValueError(f"antithetic sampling needs an even particle count, got {P}")
    if str(cfg.get("matmul_precision", "highest")).lower() not in ("highest", "float32"):
        raise _not_in_slice("matmul_precision below fp32", "Reduced matmul precision")


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


def _load_precond(cfg, model, time_steps_np, lb_np, ub_np, nZ, convert_to_enu,
                  device) -> torch.Tensor:
    H = len(time_steps_np)
    key = _precond_cache_key(cfg, model.vehicle.name, time_steps_np, lb_np,
                             ub_np, nZ, convert_to_enu)
    for cand in _precond_cache_paths(cfg, key):
        if os.path.exists(cand):
            d = np.load(cand)
            if d.shape == (H, nZ):
                return torch.tensor(np.asarray(d, np.float32), device=device)
    raise _not_in_slice(
        f"computing the hover_diag preconditioner (no cached {key}.npy)",
        "Preconditioner probe")


def make_mpc_from_config(cfg: Dict[str, Any], convert_to_enu: bool = True,
                         device: Optional[torch.device | str] = None
                         ) -> Tuple[Dict[str, Any], Tuple[Callable, Callable],
                                    Optional[Callable], MPCBundle]:
    """Core factory; ``cfg`` is an already-parsed config mapping.
    ``device=None`` is the card (``cuda``); without one this raises, and
    ``"cpu"`` must be asked for."""
    _check_slice(cfg)
    apply_fp32_policy()
    dev = resolve_device(device)
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
    cost_params = CostParams.from_config(cfg, n_u, device=dev)
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
    mppi_cfg = MPPIConfig.from_config(cfg) if solver == "mppi" else None
    num_particles = int(cfg.get("num_particles", 1))
    antithetic = bool(cfg.get("antithetic", False))
    chunk = int(cfg.get("pallas_chunk", 0) or 0)
    warm_shift = str(cfg.get("warm_shift", "repeat"))

    state_from_traj = state_from_traj_ned = None
    if cfg.get("trajectory_path"):
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
    # MPPI takes no metric: the original loads it for apg only (:509)
    precond = (_load_precond(cfg, model, time_steps_np, lb_np, ub_np, nZ,
                             convert_to_enu, dev)
               if precond_mode == "hover_diag" and solver == "apg" else None)

    bundle = MPCBundle(
        model=model, params=params, cost_params=cost_params,
        apg_config=apg_cfg, time_steps=time_steps, knot_times=knot_times,
        lb=lb, ub=ub, num_particles=num_particles,
        state_from_traj=state_from_traj, convert_to_enu=convert_to_enu,
        precond=precond, device=dev, lb_z=lb_z, ub_z=ub_z)

    def reset_fn(x, rng, xdes) -> APGState:
        """State-aware warm start (original :582-615): collective thrust
        scaled by 1/cos(tilt) plus a vertical-rate damping term; slack
        columns at their rest targets."""
        del rng, xdes
        x = torch.as_tensor(x, dtype=f32, device=dev)
        qx, qy = x[7], x[8]
        cos_tilt = 1.0 - 2.0 * (qx * qx + qy * qy)
        scale = 1.0 / torch.clamp(cos_tilt, min=0.5) + 0.3 * x[5]
        u0 = torch.clamp(cost_params.uref * torch.clamp(scale, 0.7, 1.5), lb, ub)
        yk = u0.expand(H, n_u)
        if m:
            yk = torch.cat([yk, s_hover.expand(H, m)], dim=1)
        z = torch.zeros((), dtype=f32, device=dev)
        return APGState(
            yk=yk.contiguous(), num_steps=z,
            stepsize=torch.tensor(apg_cfg.init_stepsize, dtype=f32, device=dev),
            avg_stepsize=z, avg_linesearch=z, grad_sqr=z, init_cost=z, opt_cost=z)

    def _build_ref(curr_t: torch.Tensor, xdes: torch.Tensor) -> torch.Tensor:
        """Per-stage reference states (H+1, 13) in the solver frame (NED)."""
        if state_from_traj is not None:
            if state_from_traj_ned is not None:
                return state_from_traj_ned(curr_t + knot_times)
            return state_from_traj(curr_t + knot_times)
        return xdes.expand(H + 1, 13)

    def _shift(z_opt: torch.Tensor) -> torch.Tensor:
        if warm_shift == "extrapolate":
            tail = torch.clamp(2.0 * z_opt[-1:] - z_opt[-2:-1], lb_z, ub_z)
        else:
            tail = z_opt[-1:]
        return torch.cat([z_opt[1:], tail], dim=0)

    # Stepsize carry only where the trial rule can re-grow a step
    # (original :702-708).
    carry_t = apg_cfg.reset_option in ("increase", "bb")

    def mpc_fn(x, rng, opt_state: APGState, curr_t=0.0, xdes=None,
               iter_budget: Optional[int] = None) -> MPCSolution:
        x = torch.as_tensor(x, dtype=f32, device=dev)
        xdes = x if xdes is None else torch.as_tensor(xdes, dtype=f32, device=dev)
        if convert_to_enu and state_from_traj is None:
            xdes = enu2ned(xdes)
        curr_t = torch.as_tensor(curr_t, dtype=f32, device=dev)
        x_ref = _build_ref(curr_t, xdes)
        u_prev = opt_state.yk[0]
        noise = _brownian(rng) if num_particles > 1 else None
        if solver == "apg" and apg_cfg.use_linesearch:
            st, x_evol = apg_solve_kernel(
                model, params, cost_params, apg_cfg, time_steps, x, x_ref,
                u_prev, noise, num_particles, lb_z, ub_z, opt_state.yk,
                t_init=opt_state.stepsize if carry_t else None,
                precond=precond, iter_budget=iter_budget, chunk=chunk)
        else:
            oracle = cost_oracle(model, params, cost_params, time_steps, x, x_ref,
                                 u_prev, noise, num_particles, apg_cfg.maxls,
                                 chunk=chunk)
            with torch.no_grad():
                if solver == "mppi":
                    eps, c0 = _mppi_draws(rng)
                    st = mppi_solve(oracle, opt_state.yk, lb_z, ub_z, mppi_cfg, eps, c0)
                else:
                    st = apg_solve(oracle, opt_state.yk, lb_z, ub_z, apg_cfg,
                                   precond=precond, iter_budget=iter_budget)
                x_evol = oracle.trajectory(st.yk)
        return MPCSolution(u_opt=st.yk[:, :n_u],
                           opt_state=st._replace(yk=_shift(st.yk)),
                           rng=rng, x_evol=x_evol)

    def _brownian(rng) -> torch.Tensor:
        """One solve's Brownian block (P, H, 13) on the device: drawn from a
        generator (as (H, P, 13), the view transposed), or the next block an
        iterator of draws hands in."""
        if isinstance(rng, torch.Generator):
            return draw_brownian(rng, H, num_particles, antithetic, dev).transpose(0, 1)
        if rng is None:
            raise ValueError("num_particles > 1 needs rng: a torch.Generator or "
                             "an iterator of (P, H, 13) Brownian blocks")
        return next(rng).to(dev, f32)

    def _mppi_draws(rng):
        """One solve's (eps, c0) on the device: drawn from a generator, or
        the next pair an iterator of draws hands in."""
        if isinstance(rng, torch.Generator):
            return draw_mppi_noise(rng, mppi_cfg, H, nZ, dev)
        if rng is None:
            raise ValueError("solver: mppi needs rng: a torch.Generator or an "
                             "iterator of (eps, c0) draws")
        eps, c0 = next(rng)
        return (eps.to(dev, f32), None if c0 is None else c0.to(dev, f32))

    return cfg, (reset_fn, mpc_fn), state_from_traj, bundle


def load_mpc_from_cfgfile(path: str, convert_to_enu: bool = True,
                          device: Optional[torch.device | str] = None):
    """File-path entry point (the original's ``load_mpc_from_cfgfile``);
    ``device=None`` is the card."""
    return make_mpc_from_config(load_yaml_config(path),
                                convert_to_enu=convert_to_enu, device=device)

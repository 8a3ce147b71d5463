"""MPC factory: config file -> (reset, mpc) closures on a torch device (L5).

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/mpc_loader.py``, with the
same call-site contract (``:1-59``)::

    cfg, (reset_fn, mpc_fn), state_from_traj, bundle = \\
        load_mpc_from_cfgfile(path, convert_to_enu=True, device="cuda")

- ``cfg['_time_steps']``: per-step dt list;
- ``state_from_traj(t) -> x(13)`` (ENU) or None without ``trajectory_path``;
- ``reset_fn(x, rng, xdes) -> APGState`` warm-start initializer;
- ``mpc_fn(x, rng, opt_state, curr_t=0., xdes=None, iter_budget=None) ->
  MPCSolution(u_opt[H,n_u], opt_state', rng', x_evol[H+1,13])``, with
  ``opt_state'`` carrying the one-step-shifted warm start.

The solver runs in NED/FRD; with ``convert_to_enu`` the ``xdes`` inputs and
the trajectory table are ENU and converted here. Every solve is one call
of ``ops/cuda/apg_kernel.py::apg_solve_kernel``: the hand-written kernel on
a CUDA device, its plain PyTorch version on the CPU. ``rng`` is a
``torch.Generator`` (or None); the ported configs are deterministic
(``num_particles: 1``), so it passes through unchanged, as in the original
(``:655-662``). Configs outside this slice raise ``NotImplementedError``
naming the ROADMAP.md item that brings them.
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
from sde4mbrl_px4_tpu_torch.ops.rollout import make_time_steps
from sde4mbrl_px4_tpu_torch.solver.apg import APGConfig, APGState

__all__ = ["load_mpc_from_cfgfile", "MPCBundle", "make_mpc_from_config"]


class MPCBundle(NamedTuple):
    """Everything behind the closures — for tests and benchmarks."""

    model: NeuralSDE
    params: Dict[str, Any]
    cost_params: CostParams
    apg_config: APGConfig
    time_steps: torch.Tensor     # (H,)
    knot_times: torch.Tensor     # (H+1,) cumulative times incl. 0
    lb: torch.Tensor
    ub: torch.Tensor
    num_particles: int
    state_from_traj: Optional[Callable]
    convert_to_enu: bool
    precond: Optional[torch.Tensor]   # (H, n_u) hover_diag metric or None
    device: torch.device


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sde4mbrl_px4_tpu_torch yet; "
        f"ROADMAP.md §1 '{item}' brings it")


def _check_slice(cfg: Dict[str, Any]) -> None:
    """Refuse the config features this port does not implement yet."""
    solver = str(cfg.get("solver", "apg"))
    if solver == "mppi":
        raise _not_in_slice("solver: mppi", "MPPI")
    if solver == "policy":
        raise _not_in_slice("solver: policy", "Policy solver family")
    if solver != "apg":
        raise ValueError(f"unknown solver {solver!r} (apg|mppi|policy)")
    if int(cfg.get("num_particles", 1)) > 1:
        raise _not_in_slice("num_particles > 1", "Particles")
    if cfg.get("initial_state_std") is not None:
        raise _not_in_slice("initial_state_std", "Particles")
    if cfg["cost_params"].get("risk_lambda"):
        raise _not_in_slice("cost_params.risk_lambda", "Particles")
    if int(cfg.get("pallas_chunk", 0) or 0):
        raise _not_in_slice("pallas_chunk (chunked particles, K11)", "Particles")
    if cfg.get("state_constr") is not None:
        raise _not_in_slice("state_constr", "State constraints and slack")
    if str(cfg.get("matmul_precision", "highest")).lower() not in ("highest", "float32"):
        raise _not_in_slice("matmul_precision below fp32", "Particles")


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


def _load_precond(cfg, model, time_steps_np, lb_np, ub_np, convert_to_enu,
                  device) -> torch.Tensor:
    H, n_u = len(time_steps_np), model.n_u
    key = _precond_cache_key(cfg, model.vehicle.name, time_steps_np, lb_np,
                             ub_np, n_u, convert_to_enu)
    for cand in _precond_cache_paths(cfg, key):
        if os.path.exists(cand):
            d = np.load(cand)
            if d.shape == (H, n_u):
                return torch.tensor(np.asarray(d, np.float32), device=device)
    raise _not_in_slice(
        f"computing the hover_diag preconditioner (no cached {key}.npy)",
        "Preconditioner probe")


def make_mpc_from_config(cfg: Dict[str, Any], convert_to_enu: bool = True,
                         device: Optional[torch.device | str] = None
                         ) -> Tuple[Dict[str, Any], Tuple[Callable, Callable],
                                    Optional[Callable], MPCBundle]:
    """Core factory; ``cfg`` is an already-parsed config mapping."""
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
    apg_cfg = APGConfig.from_config(cfg)
    num_particles = int(cfg.get("num_particles", 1))
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
    precond = (_load_precond(cfg, model, time_steps_np, lb_np, ub_np,
                             convert_to_enu, dev)
               if precond_mode == "hover_diag" else None)

    bundle = MPCBundle(
        model=model, params=params, cost_params=cost_params,
        apg_config=apg_cfg, time_steps=time_steps, knot_times=knot_times,
        lb=lb, ub=ub, num_particles=num_particles,
        state_from_traj=state_from_traj, convert_to_enu=convert_to_enu,
        precond=precond, device=dev)

    def reset_fn(x, rng, xdes) -> APGState:
        """State-aware warm start (original :582-615): collective thrust
        scaled by 1/cos(tilt) plus a vertical-rate damping term."""
        del rng, xdes
        x = torch.as_tensor(x, dtype=f32, device=dev)
        qx, qy = x[7], x[8]
        cos_tilt = 1.0 - 2.0 * (qx * qx + qy * qy)
        scale = 1.0 / torch.clamp(cos_tilt, min=0.5) + 0.3 * x[5]
        u0 = torch.clamp(cost_params.uref * torch.clamp(scale, 0.7, 1.5), lb, ub)
        z = torch.zeros((), dtype=f32, device=dev)
        return APGState(
            yk=u0.expand(H, n_u).contiguous(), num_steps=z,
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
            tail = torch.clamp(2.0 * z_opt[-1:] - z_opt[-2:-1], lb, ub)
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
        st, x_evol = apg_solve_kernel(
            model, params, cost_params, apg_cfg, time_steps, x, x_ref,
            opt_state.yk[0], None, 1, lb, ub, opt_state.yk,
            t_init=opt_state.stepsize if carry_t else None,
            precond=precond, iter_budget=iter_budget)
        return MPCSolution(u_opt=st.yk, opt_state=st._replace(yk=_shift(st.yk)),
                           rng=rng, x_evol=x_evol)

    return cfg, (reset_fn, mpc_fn), state_from_traj, bundle


def load_mpc_from_cfgfile(path: str, convert_to_enu: bool = True,
                          device: Optional[torch.device | str] = None):
    """File-path entry point (the original's ``load_mpc_from_cfgfile``)."""
    return make_mpc_from_config(load_yaml_config(path),
                                convert_to_enu=convert_to_enu, device=device)

"""Receding-horizon controller runtime (L5).

PyTorch counterpart of ``sde4mbrl_px4_tpu/engine/controller.py``:

- :class:`ControlAutomata`, :class:`OverrunMeter` and :class:`BudgetMeter`
  are copied from the original (host-side Python and numpy);
- :class:`CompiledMPC` loads one config on a device and makes one warm
  solve at construction (on a CUDA device that call builds the kernel);
  ``apg_mpc.deadline_ms`` arms the iteration budget (``iter_budget`` /
  ``observe_solve``, original ``:317-338``);
- :class:`RecedingHorizonController` owns the trajectory and the position
  solver, dispatches one solve per doorbell by mode (``solve_once`` /
  ``solve_async`` + ``collect_entry``) and picks commands out of the latest
  plan by time index (``pick_command`` / ``on_state``).

Each solver's ``rng`` is a CPU ``torch.Generator`` (``rng_traj`` /
``rng_pos``). The APG routes draw nothing from it; under ``solver: mppi``
each solve draws its exploration noise from it in one call and moves it to
the device in one copy (``solver/mppi.py::draw_mppi_noise``). The
deadline budget is ignored by MPPI, as in the original.

Not ported yet (ROADMAP.md §1 'Node twin and closed loop'): the
``pipeline=True`` fetch thread and the ``offset_adaptation`` estimator.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.frames import ned2enu
from sde4mbrl_px4_tpu_torch.core.types import (
    CONTROL_STATES,
    CONTROL_STATE_NAMES,
    CTRL_INACTIVE,
    CTRL_POSE_ACTIVE,
    CTRL_TEST,
    CTRL_TRAJ_ACTIVE,
    CTRL_TRAJ_IDLE,
    hover_state,
)
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
from sde4mbrl_px4_tpu_torch.engine.telemetry import OptMPCStateRecord

__all__ = ["ControlAutomata", "RecedingHorizonController", "CompiledMPC",
           "OverrunMeter", "BudgetMeter"]

_LOG = logging.getLogger("sde4mbrl_px4_tpu_torch.engine")


class OverrunMeter:
    """Counts plan-horizon overruns and logs them rate-limited (copied)."""

    def __init__(self, log_period_s: float = 1.0):
        self.count = 0
        self._last_log = 0.0
        self._period = log_period_s

    def record(self, idx: int, horizon: int, plan_age_ms: float) -> None:
        self.count += 1
        now = time.time()
        if now - self._last_log > self._period:
            self._last_log = now
            _LOG.error(
                "plan horizon overrun: pickup index %d > %d (plan age "
                "%.0f ms; solver missed real time; %d total)",
                idx, horizon - 1, plan_age_ms, self.count,
            )

    def clamp(self, idx: int, horizon: int, plan_age_ms: float) -> int:
        """Record an overrun if ``idx`` ran past the horizon, then clamp."""
        if idx > horizon - 1:
            self.record(idx, horizon, plan_age_ms)
        return max(0, min(idx, horizon - 1))


class BudgetMeter:
    """Warns (rate-limited) when blocking solves exceed the control period
    (copied)."""

    def __init__(self, log_period_s: float = 1.0):
        self.count = 0
        self._last_log = 0.0
        self._period = log_period_s

    def record(self, solve_time_s: float, budget_s: float) -> None:
        self.count += 1
        now = time.time()
        if now - self._last_log > self._period:
            self._last_log = now
            _LOG.warning(
                "blocking solve %.1f ms exceeds the %.0f ms control period "
                "(%d total): the caller cannot hold the control rate",
                solve_time_s * 1e3, budget_s * 1e3, self.count,
            )


@dataclass
class ControlAutomata:
    """Mode machine resolved on every incoming state (copied from the
    original, which mirrors the reference's ``sde_control.py:180-220``)."""

    state_from_traj: Optional[Callable] = None
    now_fn: Callable[[], float] = time.time

    pos_control: bool = False
    test_mode: bool = False
    run_trajectory: bool = False
    trajec_time: float = -1.0
    reset_done: bool = False
    weight_motors: int = 0
    target_x: np.ndarray = field(default_factory=lambda: hover_state().numpy())
    _last_traj_time: float = 0.0
    last_state: int = CONTROL_STATES["none"]

    def resolve(self) -> Tuple[int, float, np.ndarray]:
        """One automata tick -> (control_state, trajec_time, target_state)."""
        if self.pos_control:
            self.last_state = CONTROL_STATES["pos"]
        elif self.trajec_time < 0.0:
            self.last_state = CONTROL_STATES["none"]
        elif not self.run_trajectory:
            self.trajec_time = 0.0
            if self.state_from_traj is not None:
                self.target_x = np.asarray(self.state_from_traj(0.0), np.float32)
            self.last_state = CONTROL_STATES["idle"]
        else:
            now = self.now_fn()
            if self.trajec_time == 0:
                self._last_traj_time = now
                self.trajec_time = 1e-7  # sentinel: started
            else:
                self.trajec_time = now - self._last_traj_time
            self.last_state = CONTROL_STATES["traj"]
        return self.last_state, self.trajec_time, self.target_x

    def set_mode(self, mode: int, target_pose: Optional[np.ndarray] = None,
                 weight_motors: int = 110) -> Tuple[bool, str]:
        """FollowTraj-service semantics."""
        if 0 <= weight_motors <= 100:
            self.weight_motors = int(weight_motors)
            return True, "weight_motors updated"
        if not self.reset_done and mode != CTRL_INACTIVE:
            return False, "controller not reset: run controller_init first"
        if target_pose is not None:
            target_pose = np.asarray(target_pose, np.float32)
            if target_pose.shape != (13,):
                return False, (f"target_pose must be 13 floats "
                               f"[p v q w], got shape {target_pose.shape}")
            self.target_x = target_pose

        if mode == CTRL_TEST:
            self.test_mode = True
            self.pos_control = True
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "test mode activated"
        if mode == CTRL_POSE_ACTIVE:
            self.test_mode = False
            self.pos_control = True
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "position control activated"
        if mode == CTRL_INACTIVE:
            self.reset_done = False
            self.test_mode = False
            self.pos_control = False
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "controller deactivated"
        if self.run_trajectory and mode == CTRL_TRAJ_ACTIVE:
            return False, "trajectory already running"

        was_idle = self.last_state == CONTROL_STATES["idle"]
        self.trajec_time = 0.0 if mode in (CTRL_TRAJ_IDLE, CTRL_TRAJ_ACTIVE) else -1.0
        if mode == CTRL_TRAJ_ACTIVE and was_idle:
            self.run_trajectory = True
            msg = "trajectory started"
        else:
            self.run_trajectory = False
            msg = "entering idle; re-issue CTRL_TRAJ_ACTIVE from idle to start"
        self.test_mode = False
        self.pos_control = False
        return True, msg


class CompiledMPC:
    """One config's solver closures on a device, warmed at construction.

    There is no executable cache. The warm call at construction is a
    one-iteration solve whose result is dropped: on a CUDA device it is
    where the whole-solve kernel is built (or its build reused) and first
    launched. ``solves`` counts the solves made through :meth:`solve`.
    """

    def __init__(self, cfg_path: str, seed: int = 0, convert_to_enu: bool = True,
                 device: Optional[torch.device | str] = None):
        cfg, (reset_fn, mpc_fn), state_from_traj, bundle = load_mpc_from_cfgfile(
            cfg_path, convert_to_enu=convert_to_enu, device=device)
        self.cfg = cfg
        self.bundle = bundle
        self.device = bundle.device
        self.n_u = bundle.model.n_u
        self.horizon = int(bundle.time_steps.shape[0])
        self.dt_usec = float(cfg["_time_steps"][0]) * 1e6
        self.seed = seed
        self.state_from_traj = state_from_traj
        self.reset = reset_fn
        self.mpc = mpc_fn
        self.solves = 0

        apg_blk = cfg.get("apg_mpc") or {}
        self.deadline_ms = float(apg_blk.get("deadline_ms") or 0.0)
        self.deadline_min_iters = int(apg_blk.get("deadline_min_iters", 5))
        self.max_iter = int(apg_blk.get("max_iter", 200))
        self._iter_ms = None

        x0 = hover_state(self.device)
        rng = torch.Generator().manual_seed(seed)
        self.default_opt_state = self.reset(x0, rng, x0)
        warm = self.mpc(x0, rng, self.default_opt_state, 0.01, x0, 1)
        warm.u_opt.cpu()   # wait for the warm solve (and any kernel build)

    def solve(self, x, rng, opt_state, curr_t, xdes):
        """One solve, with the deadline iteration budget when armed."""
        self.solves += 1
        budget = self.iter_budget() if self.deadline_ms else None
        return self.mpc(x, rng, opt_state, curr_t, xdes, budget)

    def iter_budget(self) -> int:
        """Iteration cap for the next solve: ``deadline_ms`` over the
        measured ms/iteration, floored at ``deadline_min_iters``, capped at
        ``max_iter``; unlimited until the first measurement."""
        if not self.deadline_ms or self._iter_ms is None:
            return self.max_iter
        b = int(self.deadline_ms / max(self._iter_ms, 1e-3))
        return max(self.deadline_min_iters, min(b, self.max_iter))

    def observe_solve(self, solve_time_s: float, num_steps: float) -> None:
        """Feed a (wall solve time, iterations) pair into the ms/iteration
        EWMA (biased high: the wall time includes dispatch and transfer)."""
        if not self.deadline_ms or num_steps < 1:
            return
        per = solve_time_s * 1e3 / float(num_steps)
        self._iter_ms = (per if self._iter_ms is None
                         else 0.7 * self._iter_ms + 0.3 * per)


class RecedingHorizonController:
    """Dual-solver receding-horizon controller with time-indexed plan pickup.

    - :meth:`on_state` — the hot ingress: resolve the automata and pick the
      command out of the latest finished plan by time index;
    - :meth:`solve_once` — one solver-loop body: mode dispatch, solve, plan
      publication (blocking). :meth:`solve_async` + :meth:`collect_entry`
      split it into a dispatch that never waits on the device and a
      collection that does.
    """

    def __init__(self, traj_cfg_path: str, pos_cfg_path: str, seed: int = 0,
                 now_fn: Callable[[], float] = time.time,
                 device: Optional[torch.device | str] = None):
        self.traj = CompiledMPC(traj_cfg_path, seed=seed, device=device)
        self.pos = CompiledMPC(pos_cfg_path, seed=seed, device=device)
        self.device = self.traj.device
        if self.traj.state_from_traj is None:
            raise ValueError("trajectory config must declare trajectory_path")
        if self.pos.state_from_traj is not None:
            raise ValueError("position config must NOT declare trajectory_path")
        self.automata = ControlAutomata(
            state_from_traj=lambda t: self.traj.state_from_traj(t).cpu().numpy(),
            now_fn=now_fn,
        )
        self.seed = seed
        self.rng_traj = torch.Generator().manual_seed(seed)
        self.rng_pos = torch.Generator().manual_seed(seed + 1)
        self.opt_state_traj = self.traj.default_opt_state
        self.opt_state_pos = self.pos.default_opt_state

        max_h = max(self.traj.horizon, self.pos.horizon)
        max_u = max(self.traj.n_u, self.pos.n_u)
        self.u_plan = np.zeros((max_h, max_u), np.float32)
        self.w_plan = np.zeros((max_h, 4), np.float32)
        self.plan_sample_time_usec = -1.0
        self.plan_is_traj = False
        self.last_record = OptMPCStateRecord()
        self.overruns = OverrunMeter()
        self.budget_warn = BudgetMeter()
        self._curr_ctrl: Optional[str] = None
        self._idle_traj = False

    # ------------------------------------------------------------------ solve

    def solve_once(self, x: np.ndarray, control_state: int, trajec_time: float,
                   target_x: np.ndarray, sample_time_usec: float) -> OptMPCStateRecord:
        """One blocking solver iteration: dispatch, wait, publish."""
        record = self.collect_entry(self.solve_async(
            x, control_state, trajec_time, target_x, sample_time_usec))
        budget = (self.traj if self.plan_is_traj else self.pos).dt_usec / 1e6
        if record.solve_time > budget:
            self.budget_warn.record(record.solve_time, budget)
        return record

    def solve_async(self, x: np.ndarray, control_state: int,
                    trajec_time: float, target_x: np.ndarray,
                    sample_time_usec: float) -> tuple:
        """Dispatch one solve without waiting on the device; returns an
        opaque entry for :meth:`collect_entry`. Warm starts advance here."""
        mode = CONTROL_STATE_NAMES.get(int(control_state), "none")
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        t0 = time.perf_counter()

        if self._curr_ctrl is None or (self._curr_ctrl == "none" and mode != "none"):
            self.opt_state_traj = self.traj.reset(x, self.rng_traj, x)
            self.opt_state_pos = self.pos.reset(x, self.rng_pos, x)
        if mode == "idle" and self._curr_ctrl in (None, "none", "pos"):
            self.opt_state_traj = self.traj.reset(x, self.rng_traj, x)
            self._idle_traj = True

        target = torch.as_tensor(np.asarray(target_x, np.float32), device=self.device)
        tt = max(float(trajec_time), 0.0)

        if mode == "none":
            self._curr_ctrl = "none"
            # hold the current state: xdes is the state in the xdes frame
            sol = self.pos.solve(x, self.rng_pos, self.opt_state_pos, 0.0, ned2enu(x))
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            used = self.opt_state_pos
        elif mode == "idle":
            self._curr_ctrl = "idle"
            sol = self.pos.solve(x, self.rng_pos, self.opt_state_pos, 0.0, target)
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            self._idle_traj = not self._idle_traj
            if self._idle_traj:
                # pre-warm the trajectory solver every 2nd tick
                pre = self.traj.solve(x, self.rng_traj, self.opt_state_traj, tt, x)
                self.opt_state_traj, self.rng_traj = pre.opt_state, pre.rng
            used = self.opt_state_traj
        elif mode == "traj":
            self._curr_ctrl = "traj"
            sol = self.traj.solve(x, self.rng_traj, self.opt_state_traj, tt, x)
            self.opt_state_traj, self.rng_traj = sol.opt_state, sol.rng
            used = self.opt_state_traj
        elif mode == "pos":
            self._curr_ctrl = "pos"
            sol = self.pos.solve(x, self.rng_pos, self.opt_state_pos, 0.0, target)
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            used = self.opt_state_pos
        else:
            raise ValueError(f"unknown control state {control_state}")
        return (sol, used, mode, int(control_state), float(sample_time_usec), t0)

    def collect_entry(self, entry: tuple) -> OptMPCStateRecord:
        """Block on a dispatched entry and publish its plan + stats."""
        return self._publish(*self._fetch(*entry))

    def _fetch(self, sol, used, mode: str, control_state: int,
               sample_time_usec: float, t0: float) -> tuple:
        """Wait for a dispatched solve and copy its outputs to the host in
        one transfer. Mutates no controller state."""
        stats = torch.stack([used.avg_linesearch, used.stepsize, used.num_steps,
                             used.grad_sqr, used.avg_stepsize, used.init_cost,
                             used.opt_cost]).reshape(-1)
        flat = torch.cat([sol.u_opt.reshape(-1), sol.x_evol.reshape(-1), stats]).cpu()
        solve_time = time.perf_counter() - t0
        nu = sol.u_opt.numel()
        nx = sol.x_evol.numel()
        u_opt = flat[:nu].numpy().reshape(sol.u_opt.shape)
        x_evol = flat[nu:nu + nx].numpy().reshape(sol.x_evol.shape)
        stats_host = tuple(float(v) for v in flat[nu + nx:])
        return (u_opt, x_evol, stats_host, mode, control_state,
                sample_time_usec, solve_time)

    def _publish(self, u_opt, x_evol, stats_host, mode: str,
                 control_state: int, sample_time_usec: float,
                 solve_time: float) -> OptMPCStateRecord:
        """Publish a fetched plan + stats (latest wins)."""
        thrust = np.sum(u_opt, axis=1) / u_opt.shape[1]
        w_opt = np.stack(
            [thrust, x_evol[1:, 10], x_evol[1:, 11], x_evol[1:, 12]], axis=-1
        ).astype(np.float32)

        self.u_plan[: u_opt.shape[0], : u_opt.shape[1]] = u_opt
        self.w_plan[: w_opt.shape[0]] = w_opt
        self.plan_sample_time_usec = float(sample_time_usec)
        # pickup metadata follows the solver that PRODUCED the plan
        self.plan_is_traj = mode == "traj"

        avg_ls, stepsize, num_steps, grad_sqr, avg_stepsize, c0, cT = stats_host
        # idle publishes the pos plan with the traj pre-warm's stats: its
        # wall time spans both solves, so it does not calibrate the budget
        if mode == "traj":
            self.traj.observe_solve(solve_time, float(num_steps))
        elif mode in ("pos", "none"):
            self.pos.observe_solve(solve_time, float(num_steps))
        self.last_record = OptMPCStateRecord(
            stamp=time.time(), avg_linesearch=float(avg_ls),
            avg_stepsize=float(avg_stepsize), stepsize=float(stepsize),
            grad_norm=float(grad_sqr), cost_init=float(c0), opt_cost=float(cT),
            num_steps=int(num_steps), solve_time=solve_time,
            callback_dt=0.0, state_dt=0.0,
            ctrl_state=CONTROL_STATE_NAMES.get(int(control_state), "none"),
            mpc_indx=0,
        )
        return self.last_record

    # ----------------------------------------------------------------- pickup

    def pick_command(self, sample_time_usec: float) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """Time-indexed plan pickup -> (motor_cmd[6], thrust_and_rates[4],
        index), or None before the first plan. Past the horizon the index
        is clamped and the overrun counted."""
        if self.plan_sample_time_usec <= 0:
            return None
        active = self.traj if self.plan_is_traj else self.pos
        idx = self.overruns.clamp(
            int((sample_time_usec - self.plan_sample_time_usec) / active.dt_usec),
            active.horizon,
            (sample_time_usec - self.plan_sample_time_usec) / 1e3,
        )
        u = self.u_plan[idx, : active.n_u]
        if u.shape[0] < 6:
            u = np.concatenate([u, np.zeros(6 - u.shape[0], np.float32)])
        return u.copy(), self.w_plan[idx].copy(), idx

    # ------------------------------------------------------------------ state

    def on_state(self, x: np.ndarray, sample_time_usec: float):
        """Hot ingress tick: resolve the automata, return the picked command."""
        control_state, trajec_time, target = self.automata.resolve()
        cmd = self.pick_command(sample_time_usec)
        return control_state, trajec_time, target, cmd

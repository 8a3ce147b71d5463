"""Closed-loop plant simulator (L7) — the framework's Gazebo/SITL stand-in.

:class:`FCUSim` is copied from ``sde4mbrl_px4_tpu/sim/plant.py`` (``:90``,
numpy); :class:`SDEPlant` (``:34``) is its PyTorch twin over the port's
``ops/rollout.py::em_step``. The port may not import the JAX package,
whose ``__init__`` imports JAX.

The reference's system-level harness is PX4 SITL + Gazebo (SURVEY.md §4:
``make px4_sitl gazebo``), plus a PX4-side watchdog that kills the MPC on
command staleness > 20 ms or plan-horizon overrun
(``basic_control.py:35-42``). Closed-loop tests here use the SDE model
itself, integrated at a finer dt, as the plant:

- :class:`SDEPlant` — integrates the (possibly different) model params at
  ``sim_dt`` sub-steps per control period, with optional process noise
  drawn from the plant's own ``torch.Generator``;
- :class:`FCUSim` — wraps the plant with the FCU-side behaviors the
  engine must survive: MPC_FULL_STATE emission at a fixed rate, the 20 ms
  command-staleness watchdog, the ``mpc_on`` engagement levels
  (off / test / on), and the ``weight_motors`` blend (0 = thrust+rates
  executed by a simple rate loop, 100 = raw motor commands;
  ``srv/FollowTraj.srv:10``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core.types import CONTROL_STATES, hover_state
from sde4mbrl_px4_tpu_torch.models.params_io import params_from_numpy
from sde4mbrl_px4_tpu_torch.models.sde_model import NeuralSDE
from sde4mbrl_px4_tpu_torch.ops.rollout import em_step

__all__ = ["SDEPlant", "FCUSim"]


class SDEPlant:
    """Ground-truth vehicle: EM-integrates a neural-SDE model at fine dt.

    ``params`` is a checkpoint's tree of numpy arrays (``load_params``); the
    plant keeps its own fp32 copy on ``device``. The plant runs on the host CPU
    unless asked otherwise: its sub-steps are tiny and latency-bound, and
    the accelerator belongs to the solver (original ``:46-52``).
    ``process_noise`` draws each sub-step's N(0, 1) increment from the
    plant's ``torch.Generator``, seeded with ``seed``.
    """

    def __init__(self, model: NeuralSDE, params: Dict[str, Any],
                 sim_dt: float = 0.005, process_noise: bool = False, seed: int = 0,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.model = NeuralSDE.for_vehicle(model.vehicle, self.device)
        self.params = params_from_numpy(params, self.device)
        self.sim_dt = float(sim_dt)
        self.process_noise = process_noise
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._dt = torch.tensor(self.sim_dt, dtype=torch.float32, device=self.device)
        self.x = hover_state().numpy()
        self.t = 0.0

    def reset(self, x0=None, t0: float = 0.0) -> None:
        self.x = np.asarray(x0 if x0 is not None else hover_state().numpy(), np.float32)
        self.t = t0

    def step(self, u: np.ndarray, duration: float) -> np.ndarray:
        """Advance the plant ``duration`` seconds under constant control."""
        n = max(1, int(round(duration / self.sim_dt)))
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(self.x, np.float32), device=self.device)
            u_t = torch.as_tensor(np.asarray(u, np.float32), device=self.device)
            for _ in range(n):
                z = (torch.randn(13, generator=self.gen, device=self.device)
                     if self.process_noise else None)
                x = em_step(self.model, self.params, x, u_t, self._dt, z)
            self.x = x.cpu().numpy()
        self.t += n * self.sim_dt
        return self.x


class FCUSim:
    """FCU behavioral shim around the plant: engagement levels, watchdog,
    motor/rate blending, state message emission."""

    # Watchdog status codes (reference MPC_STATUS, basic_control.py:35-42).
    MPC_OFF = 0
    MPC_ON = 1
    MPC_TIMEOUT = 2      # motor msg staleness > 20 ms
    MPC_HORIZON_OVERRUN = 3

    def __init__(self, plant, state_rate_hz: float = 100.0,
                 staleness_bound_s: float = 0.020):
        self.plant = plant
        self.state_dt = 1.0 / state_rate_hz
        self.staleness_bound = staleness_bound_s
        self.status = self.MPC_OFF
        self.last_cmd_time: Optional[float] = None
        self.last_cmd: Optional[Tuple] = None
        # Plant surface: SDEPlant exposes these through its model;
        # RigidBodyPlant (sim/rigid_body.py — the independent
        # Gazebo-role plant) exposes them directly.
        if hasattr(plant, "hover_u"):
            self.hover_u = float(plant.hover_u)
            self.n_u = int(plant.n_u)
            self._mixing = np.asarray(plant.mixing)
        else:
            self.hover_u = plant.model.vehicle.hover_u
            self.n_u = plant.model.n_u
            self._mixing = np.asarray(plant.model.vehicle.mixing)
        # Firmware parameter store (the reference pushes COM_RCL_EXCEPT=4
        # pre-flight to disable the RC-loss failsafe,
        # ``basic_control.py:147-149``).
        self.params: dict = {}
        self._last_applied = np.zeros(self.n_u, np.float32)

    def full_state_msg(self) -> Tuple[np.ndarray, float]:
        """(state13, time_usec) as the FCU would stream it."""
        return self.plant.x.copy(), self.plant.t * 1e6

    @property
    def applied_motors4(self) -> np.ndarray:
        """Last APPLIED motor outputs, first 4 — the m1..m4 readings
        MPC_FULL_STATE carries (reference message fields, plotted by
        ``launch/pj_setpoint_layout.xml``); zeros before the first period."""
        u = self._last_applied
        out = np.zeros(4, np.float32)
        out[: min(4, u.shape[0])] = u[:4]
        return out

    def push_cmd(self, motors6: np.ndarray, thrust_rates4: np.ndarray,
                 mpc_on: int, weight_motors: int) -> None:
        """Receive an MPC_MOTORS_CMD (called by the engine's cmd sink)."""
        self.last_cmd_time = self.plant.t
        self.last_cmd = (np.asarray(motors6), np.asarray(thrust_rates4),
                         int(mpc_on), int(weight_motors))

    def _effective_u(self) -> np.ndarray:
        """Apply engagement level + watchdog + blend to produce motor input."""
        if self.last_cmd is None:
            self.status = self.MPC_OFF
            return np.full(self.n_u, self.hover_u, np.float32)
        motors6, tr4, mpc_on, weight = self.last_cmd

        # Watchdog: staleness bound (reference basic_control.py:39).
        if self.plant.t - self.last_cmd_time > self.staleness_bound:
            self.status = self.MPC_TIMEOUT
            return np.full(self.n_u, self.hover_u, np.float32)

        engaged = mpc_on in (CONTROL_STATES["pos"], CONTROL_STATES["idle"],
                             CONTROL_STATES["traj"])
        if not engaged:  # off/reset/test: FCU ignores commands (CTRL_TEST)
            self.status = self.MPC_OFF
            return np.full(self.n_u, self.hover_u, np.float32)

        self.status = self.MPC_ON
        u_motor = motors6[: self.n_u]
        # weight_motors blend: 100 = raw motors; 0 = thrust+rate tracked by a
        # proportional body-rate loop (stand-in for PX4's rate controller).
        w = np.clip(weight / 100.0, 0.0, 1.0)
        u_rate = self._rate_loop(tr4)
        return (w * u_motor + (1.0 - w) * u_rate).astype(np.float32)

    def _rate_loop(self, thrust_rates4: np.ndarray) -> np.ndarray:
        """Simple P rate controller mapping [T, wx, wy, wz] to motors via the
        vehicle mixing pseudo-inverse (the PX4-side fallback executor)."""
        thrust, w_des = float(thrust_rates4[0]), thrust_rates4[1:4]
        w_cur = self.plant.x[10:13]
        k_rate = 0.6
        tau_cmd = k_rate * (w_des - w_cur)
        # wrench = [T_total, tau]: T_total target = thrust * n_motors * ct
        mix = self._mixing
        wrench = np.concatenate([[thrust * np.sum(mix[0])], tau_cmd])
        u = np.linalg.pinv(mix) @ wrench
        return np.clip(u, 1e-4, 1.0).astype(np.float32)

    def run_control_period(self, duration: float) -> np.ndarray:
        """Advance one control period applying the effective motor input."""
        self._last_applied = self._effective_u()
        return self.plant.step(self._last_applied, duration)

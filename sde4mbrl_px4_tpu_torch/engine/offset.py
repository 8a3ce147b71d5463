"""Host-side disturbance-offset adaptation (opt-in) — integral action
for unmodeled steady disturbances.

Copied from ``sde4mbrl_px4_tpu/engine/offset.py`` (numpy only): the port
may not import the JAX package, whose ``__init__`` imports JAX.

A finite-horizon MPC with no integral action holds a steady OFFSET under
constant model mismatch (unmodeled payload, battery sag, wind): the
mismatch sweep (``examples/mismatch_sweep.py``) measures 0.17–0.46 m of
hover bias at mass ±20%. The classic fix is reference shaping: integrate
the position error and command a target shifted PAST the true target so
the biased closed loop settles ON it.

This estimator is deliberately host-side, numpy-only and solver-agnostic
— it wraps ANY of the solver families without touching their compiled
programs (no retrace, no golden churn, no device dispatch on the host
path; everything stays OFF by default):

    est = DisturbanceEstimator(gain=..., limit=...)
    target_shifted = est.update(x_ned, target_enu, dt_s)  # per tick

Anti-windup: the integrator clamps at ``limit`` meters and only
integrates when the error is within ``capture`` (far from the target the
transient would wind the integrator up and cause overshoot).

Engine wiring: ``RecedingHorizonController(..., offset_adaptation=
{"gain": 0.4, "limit": 1.0})`` applies it to the POS/setpoint mode only
(reference automata target path) with dt measured from the state
timestamps (solve rate varies with the doorbell rate), and resets it
wherever the solvers' warm starts reset (before its first tick of a
fresh engagement). Idle mode is deliberately
excluded: it is the pre-engagement hold of the reference protocol — the
FCU is typically not executing the engine's commands yet, and an
integrator running open-loop there winds up to ``limit`` before the
loop ever closes. The same caveat applies to CTRL_TEST-style operation
in pos mode (commands computed but ignored): arm adaptation only when
the vehicle actually flies the engine's outputs. Trajectory mode is out
of scope: its reference comes from the time-indexed window, not
``target_x`` (``sde_control.py:412``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["DisturbanceEstimator"]


class DisturbanceEstimator:
    """Integral reference-shaping on the position target (ENU in/out,
    integration in NED where the plant state lives)."""

    def __init__(self, gain: float = 0.4, limit: float = 1.0,
                 dt: float = 0.05, capture: float = 2.0,
                 leak: float = 0.0):
        self.gain = float(gain)
        self.limit = float(limit)
        self.dt = float(dt)          # default step when update() gets no dt
        self.capture = float(capture)
        self.leak = float(leak)
        self.offset_ned = np.zeros(3)

    def reset(self) -> None:
        self.offset_ned[:] = 0.0

    @staticmethod
    def _swap_flip(p):
        """ENU<->NED position map (an involution): (x,y,z) -> (y,x,-z).
        numpy twin of ``core.frames.enu2ned_pos`` — the jnp original
        would dispatch to the default device on every host-side tick."""
        return np.array([p[1], p[0], -p[2]], np.float64)

    def update(self, x_ned: np.ndarray, target_enu: np.ndarray,
               dt_s: float = None) -> np.ndarray:
        """One control tick: integrate the NED position error over the
        MEASURED elapsed time ``dt_s`` (falls back to the configured
        ``dt``) and return the SHIFTED 13-dim ENU target to hand the
        solver. The effective integral gain is gain/second regardless of
        how often the caller ticks."""
        step = self.dt if dt_s is None else min(max(float(dt_s), 0.0), 0.5)
        target_enu = np.asarray(target_enu, np.float32)
        tgt_ned = self._swap_flip(target_enu[:3])
        err = tgt_ned - np.asarray(x_ned[:3], np.float64)
        if np.linalg.norm(err) < self.capture:
            self.offset_ned *= (1.0 - self.leak * step)
            self.offset_ned += self.gain * step * err
            np.clip(self.offset_ned, -self.limit, self.limit,
                    out=self.offset_ned)
        out = target_enu.copy()
        out[:3] = (target_enu[:3].astype(np.float64)
                   + self._swap_flip(self.offset_ned)).astype(np.float32)
        return out

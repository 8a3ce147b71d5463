"""Analytic reference-trajectory generators (L1).

Copied from ``sde4mbrl_px4_tpu/models/trajgen.py`` (numpy only; the port
does not import the JAX package).

The reference consumes trajectory CSVs produced offline by its external
library (circle / lemniscate files named in configs, e.g.
``fast2_lemn.csv`` at ``launch/iris_sitl_traj_mpc.yaml:6``) with header
``t,x,y,z,vx,vy,vz,ax,ay,az,yaw`` in ENU
(``geometric_controller.cpp:463``). These generators produce the same file
format from closed-form circle / lemniscate primitives with exact
velocities and accelerations.
"""
from __future__ import annotations

import io
import os

import numpy as np

__all__ = ["circle_trajectory", "lemniscate_trajectory", "write_trajectory_csv"]

_HEADER = "t,x,y,z,vx,vy,vz,ax,ay,az,yaw"


def _pack(t, p, v, a, yaw) -> np.ndarray:
    return np.concatenate([t[:, None], p, v, a, yaw[:, None]], axis=1)


def _time_warp(t: np.ndarray, ramp: float):
    """Smooth from-rest time warp: phase runs on tau(t) whose rate
    smoothsteps 0 -> 1 over ``ramp`` seconds (tau = t - ramp/2 after).

    Returns (tau, dtau, ddtau) — exact derivatives so warped trajectories
    keep analytic velocity/acceleration columns. ramp=0 is the identity
    (the reference's offline CSVs start at full speed; a ramp makes the
    trajectory flyable from hover without a catch-up maneuver).
    """
    if ramp <= 0.0:
        one = np.ones_like(t)
        return t, one, np.zeros_like(t)
    u = np.clip(t / ramp, 0.0, 1.0)
    s = 3 * u * u - 2 * u ** 3                       # smoothstep rate
    ds = (6 * u - 6 * u * u) / ramp                  # d(rate)/dt
    tau_ramp = ramp * (u ** 3 - 0.5 * u ** 4)        # integral of the rate
    tau = np.where(t < ramp, tau_ramp, t - 0.5 * ramp)
    return tau, s, ds


def circle_trajectory(radius: float = 1.0, period: float = 6.0, z: float = 1.5,
                      n_laps: float = 2.0, dt: float = 0.02,
                      yaw_follow: bool = True, ramp: float = 0.0) -> np.ndarray:
    """ENU circle at constant altitude, exact derivatives; ``ramp`` seconds
    of smooth from-rest spin-up (see :func:`_time_warp`)."""
    t = np.arange(0.0, n_laps * period + dt, dt)
    w = 2 * np.pi / period
    tau, dtau, ddtau = _time_warp(t, ramp)
    th = w * tau
    thd = w * dtau
    thdd = w * ddtau
    c, s = np.cos(th), np.sin(th)
    p = np.stack([radius * c, radius * s, np.full_like(t, z)], 1)
    v = np.stack([-radius * s * thd, radius * c * thd, np.zeros_like(t)], 1)
    a = np.stack(
        [-radius * (c * thd * thd + s * thdd),
         radius * (-s * thd * thd + c * thdd), np.zeros_like(t)], 1)
    # Yaw from the path TANGENT (-sin, cos), not from v: at a from-rest
    # ramp point v=(-0,+0) and arctan2(+0,-0)=pi would bake a 90-degree
    # yaw step into the first sample.
    yaw = np.arctan2(c, -s) if yaw_follow else np.zeros_like(t)
    return _pack(t, p, v, a, yaw)


def lemniscate_trajectory(scale: float = 1.5, period: float = 8.0, z: float = 1.5,
                          n_laps: float = 2.0, dt: float = 0.02,
                          ramp: float = 0.0) -> np.ndarray:
    """Figure-eight (Gerono lemniscate) in ENU: x = A sin(th), y = A sin(th)cos(th);
    ``ramp`` seconds of smooth from-rest spin-up."""
    t = np.arange(0.0, n_laps * period + dt, dt)
    w = 2 * np.pi / period
    tau, dtau, ddtau = _time_warp(t, ramp)
    th = w * tau
    thd = w * dtau
    thdd = w * ddtau
    s, c = np.sin(th), np.cos(th)
    x = scale * s
    y = scale * s * c
    # d/dth: x' = A c ; y' = A (c^2 - s^2) ; x'' = -A s ; y'' = -4 A s c
    vx = scale * c * thd
    vy = scale * (c * c - s * s) * thd
    ax = -scale * s * thd * thd + scale * c * thdd
    ay = -4 * scale * s * c * thd * thd + scale * (c * c - s * s) * thdd
    p = np.stack([x, y, np.full_like(t, z)], 1)
    v = np.stack([vx, vy, np.zeros_like(t)], 1)
    a = np.stack([ax, ay, np.zeros_like(t)], 1)
    yaw = np.zeros_like(t)
    return _pack(t, p, v, a, yaw)


def write_trajectory_csv(path: str, rows: np.ndarray) -> None:
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.StringIO()
    np.savetxt(buf, rows, delimiter=",", header=_HEADER, comments="", fmt="%.9g")
    with open(path, "w") as f:
        f.write(buf.getvalue())

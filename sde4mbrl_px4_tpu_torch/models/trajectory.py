"""Reference-trajectory tables and the ``state_from_traj`` sampler (L1).

PyTorch counterpart of ``sde4mbrl_px4_tpu/models/trajectory.py``. The CSV
parser is the original's numpy code (header ``t,x,y,z,vx,vy,vz,ax,ay,az,yaw``,
ENU); the differential-flatness attitude is computed with the port's torch
quaternion functions in fp32 on the CPU, as the original computes it with
JAX on the CPU. :func:`make_state_from_traj` (original ``:112-165``) builds
the sampler: linear interpolation between knots, quaternion re-normalized
after the lerp, clamped to the end points outside the table.
"""
from __future__ import annotations

import io
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.core.frames import enu2ned

__all__ = ["TrajectoryTable", "load_trajectory_csv", "parse_trajectory_csv",
           "make_state_from_traj"]

_G = 9.81
_REQUIRED = ("t", "x", "y", "z", "vx", "vy", "vz", "ax", "ay", "az", "yaw")


class TrajectoryTable(NamedTuple):
    """Dense knot table, host-resident: times (N,) and 13-states (N, 13)."""

    times: np.ndarray
    states: np.ndarray

    @property
    def duration(self) -> float:
        return float(self.times[-1])


def load_trajectory_csv(path: str, convert_to_ned: bool = True) -> TrajectoryTable:
    """Parse a reference-format trajectory CSV into a knot table."""
    with open(os.path.expanduser(path), "r") as f:
        return parse_trajectory_csv(f.read(), convert_to_ned=convert_to_ned)


def parse_trajectory_csv(text: str, convert_to_ned: bool = True) -> TrajectoryTable:
    header, *rows = [ln for ln in text.strip().splitlines() if ln.strip()]
    cols = [c.strip() for c in header.split(",")]
    missing = [c for c in _REQUIRED if c not in cols]
    if missing:
        raise ValueError(f"trajectory CSV missing columns {missing}; has {cols}")
    idx = {c: cols.index(c) for c in _REQUIRED}

    data = np.genfromtxt(io.StringIO("\n".join(rows)), delimiter=",", dtype=np.float64)
    data = np.nan_to_num(np.atleast_2d(data), nan=0.0)

    t = data[:, idx["t"]]
    pos = data[:, [idx["x"], idx["y"], idx["z"]]]
    vel = data[:, [idx["vx"], idx["vy"], idx["vz"]]]
    acc = data[:, [idx["ax"], idx["ay"], idx["az"]]]
    yaw = data[:, idx["yaw"]]

    # Differential-flatness attitude in ENU: body z along (a + g_up), fp32.
    g_up = np.array([0.0, 0.0, _G])
    q = quat.acc_yaw_to_q(torch.tensor(acc + g_up, dtype=torch.float32),
                          torch.tensor(yaw, dtype=torch.float32)).numpy()

    # Body-rate prior: yaw rate about body z only.
    if len(t) > 1:
        yaw_rate = np.gradient(np.unwrap(yaw), t, edge_order=1)
    else:
        yaw_rate = np.zeros_like(yaw)
    omega = np.stack([np.zeros_like(yaw_rate), np.zeros_like(yaw_rate), yaw_rate], axis=-1)

    states = np.concatenate([pos, vel, q, omega], axis=-1).astype(np.float32)
    if convert_to_ned:
        states = enu2ned(torch.from_numpy(states)).numpy()
    return TrajectoryTable(times=np.asarray(t, np.float32),
                           states=np.asarray(states, np.float32))


def make_state_from_traj(table: TrajectoryTable,
                         device: torch.device | str = "cpu") -> Callable:
    """Build ``state_from_traj(t) -> x(..., 13)`` on ``device``.

    ``t`` is a float or a tensor of any shape. Uniform knot grids (every
    shipped CSV) index directly; others use ``searchsorted``.
    """
    times = torch.tensor(table.times, dtype=torch.float32, device=device)
    states = torch.tensor(table.states, dtype=torch.float32, device=device)
    n = times.shape[0]

    tn = np.asarray(table.times, np.float64)
    dts = np.diff(tn)
    tol = 1e-3 * abs(dts[0]) + 8 * np.finfo(np.float32).eps * max(
        1.0, abs(tn[-1])) if dts.size else 0.0
    uniform = bool(dts.size > 0 and dts.min() > 0
                   and np.abs(dts - dts[0]).max() <= tol)
    dt0 = torch.tensor(float((tn[-1] - tn[0]) / (len(tn) - 1)) if uniform else 1.0,
                       dtype=torch.float32, device=device)

    def state_from_traj(t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        if uniform:
            # clamp in float before the int cast (far-future query times)
            k = torch.clamp(torch.floor((t - times[0]) / dt0), 0.0, n - 1)
            hi = torch.clamp(k.to(torch.int64) + 1, 1, n - 1)
        else:
            hi = torch.clamp(torch.searchsorted(times, t, right=True), 1, n - 1)
        lo = hi - 1
        t0, t1 = times[lo], times[hi]
        alpha = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
        x = states[lo] + alpha[..., None] * (states[hi] - states[lo])
        return torch.cat([x[..., 0:6], quat.qnormalize(x[..., 6:10]),
                          x[..., 10:13]], dim=-1)

    return state_from_traj

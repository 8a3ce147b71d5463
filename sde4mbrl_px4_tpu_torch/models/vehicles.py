"""Vehicle (airframe) definitions: iris quad + hexacopter (L1).

Copied from ``sde4mbrl_px4_tpu/models/vehicles.py`` (pure numpy): the port
may not import the JAX package, whose ``__init__`` imports JAX.

The reference supports two airframes, distinguished only by their config
files: 4-motor iris (``launch/iris_sitl_traj_mpc.yaml:10-11``) and 6-motor
hexa (``launch/hexa_traj_mpc.yaml:11-12``), with per-motor normalized thrust
commands in ``[1e-4, 1]`` and hover references ``uref`` of 0.71 (iris) /
0.33 (hexa) per motor (``iris_sitl_traj_mpc.yaml:33``,
``hexa_traj_mpc.yaml:21``).

Here an airframe is a static description: mass/inertia prior, rotor layout,
and the (4 x n_motors) mixing matrix mapping normalized motor commands to
[collective thrust, roll, pitch, yaw torque] in the FRD body frame. The
physical constants are *priors* — the learned residual nets absorb model
mismatch, as in the reference's learned-SDE approach.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["VehicleConfig", "iris_config", "hexa_config", "vehicle_from_name"]

_G = 9.81


class VehicleConfig(NamedTuple):
    name: str
    n_motors: int
    mass: float                 # kg
    inertia: np.ndarray         # (3,) diagonal body inertia, kg m^2
    mixing: np.ndarray          # (4, n_motors): u -> [T, tau_x, tau_y, tau_z]
    hover_u: float              # per-motor normalized hover command


def _mixing(rotor_xy: np.ndarray, spin_dir: np.ndarray, ct: float, cm: float) -> np.ndarray:
    """Build the FRD mixing matrix from rotor geometry.

    Thrust of rotor i is ``ct * u_i`` along body -z (FRD, up). With rotor at
    ``r_i = (x_i, y_i, 0)``: torque ``r_i x (-T e_z) = (-T y_i, T x_i, 0)``
    plus the reaction yaw torque ``spin_dir_i * cm * u_i``.
    """
    n = rotor_xy.shape[0]
    m = np.zeros((4, n))
    m[0, :] = ct
    m[1, :] = -ct * rotor_xy[:, 1]
    m[2, :] = ct * rotor_xy[:, 0]
    m[3, :] = cm * spin_dir
    return m


def iris_config() -> VehicleConfig:
    """Gazebo iris quad (X layout, PX4 quad_x motor order).

    ct chosen so hover at uref=0.71/motor balances gravity:
    ``4 * ct * 0.71 = m * g``.
    """
    mass = 1.5
    ct = mass * _G / (4 * 0.71)
    cm = 0.06 * ct  # yaw moment arm prior
    L = 0.25
    s = L / np.sqrt(2.0)
    # PX4 quad_x order: m1 front-right(CCW), m2 rear-left(CCW),
    # m3 front-left(CW), m4 rear-right(CW); body FRD (x fwd, y right).
    rotor_xy = np.array([[s, s], [-s, -s], [s, -s], [-s, s]])
    spin = np.array([1.0, 1.0, -1.0, -1.0])
    return VehicleConfig(
        name="iris",
        n_motors=4,
        mass=mass,
        inertia=np.array([0.029, 0.029, 0.055]),
        mixing=_mixing(rotor_xy, spin, ct, cm),
        hover_u=0.71,
    )


def hexa_config() -> VehicleConfig:
    """Generic X-layout hexacopter (6 motors at 60° spacing)."""
    mass = 2.6
    ct = mass * _G / (6 * 0.33)
    cm = 0.06 * ct
    L = 0.30
    # Hexa-x: rotors every 60°, starting 30° off body-x; alternating spin.
    ang = np.deg2rad(np.array([30.0, 90.0, 150.0, 210.0, 270.0, 330.0]))
    rotor_xy = L * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    spin = np.array([1.0, -1.0, 1.0, -1.0, 1.0, -1.0])
    return VehicleConfig(
        name="hexa",
        n_motors=6,
        mass=mass,
        inertia=np.array([0.065, 0.065, 0.12]),
        mixing=_mixing(rotor_xy, spin, ct, cm),
        hover_u=0.33,
    )


def vehicle_from_name(name: str) -> VehicleConfig:
    if name.startswith("iris"):
        return iris_config()
    if name.startswith("hexa"):
        return hexa_config()
    raise ValueError(f"unknown vehicle {name!r} (expected iris* or hexa*)")

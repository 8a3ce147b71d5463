"""Geometric SE(3)/quaternion baseline controller (L7).

PyTorch counterpart of ``sde4mbrl_px4_tpu/baselines/geometric.py``: the
reference's non-learned comparison controller (reference
``geometric_controller/geometric_controller.cpp``), in two interchangeable
implementations held to each other by the tests:

- :func:`geometric_control` — plain tensor functions on the caller's
  device, over any leading batch (the original's ``:83-128``);
- :class:`NativeGeometricController` — the ctypes binding onto the C++
  implementation (``csrc/geometric_controller.cpp``, built into
  ``csrc/libmpc_native.so`` by ``make -C csrc``), the real-time host path,
  with the CSV trajectory follower and its stage cache; copied from the
  original's ``:132-225``.

Pipeline (reference ``controlLoopBody``): position PD with a norm-clipped
feedback acceleration, feedforward and rotor-drag compensation ->
``acc2quaternion`` -> attitude law (1 = quaternion error / Brescianini,
2 = SE(3) / Lee) -> thrust ``clamp(c * a_des . z_b + offset, 0, 1)``.
Frames: world ENU, body FLU, as the reference node receives them.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sde4mbrl_px4_tpu_torch.core import quaternion as quat
from sde4mbrl_px4_tpu_torch.io.mavlink import load_native

__all__ = ["ERROR_GEOMETRIC", "ERROR_QUATERNION", "GeoParams", "NativeGeometricController",
           "geometric_control"]

ERROR_QUATERNION = 1
ERROR_GEOMETRIC = 2


class GeoParams(NamedTuple):
    """Parameters; defaults mirror the reference node's
    (``geometric_controller.cpp:30-45``)."""

    attctrl_tau: float = 0.1
    norm_thrust_const: float = 0.05
    norm_thrust_offset: float = 0.1
    max_fb_acc: float = 9.0
    gravity: float = 9.8
    drag_d: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    kp: Tuple[float, float, float] = (8.0, 8.0, 10.0)
    kv: Tuple[float, float, float] = (1.5, 1.5, 3.3)
    ctrl_mode: int = ERROR_QUATERNION
    feedthrough: bool = False

    @staticmethod
    def from_yaml(path: str) -> "GeoParams":
        """Flat key:value config (reference ``launch/iris_geoctrl.yaml``)."""
        import yaml

        with open(os.path.expanduser(path)) as f:
            d = yaml.safe_load(f) or {}
        base = GeoParams()
        return GeoParams(
            attctrl_tau=float(d.get("attctrl_tau", base.attctrl_tau)),
            norm_thrust_const=float(d.get("norm_thrust_const", base.norm_thrust_const)),
            norm_thrust_offset=float(d.get("norm_thrust_offset", base.norm_thrust_offset)),
            max_fb_acc=float(d.get("max_acc", base.max_fb_acc)),
            gravity=float(d.get("gravity", base.gravity)),
            drag_d=(float(d.get("drag_dx", 0.0)), float(d.get("drag_dy", 0.0)),
                    float(d.get("drag_dz", 0.0))),
            kp=(float(d.get("Kp_x", 8.0)), float(d.get("Kp_y", 8.0)),
                float(d.get("Kp_z", 10.0))),
            kv=(float(d.get("Kv_x", 1.5)), float(d.get("Kv_y", 1.5)),
                float(d.get("Kv_z", 3.3))),
            ctrl_mode=int(d.get("ctrl_mode", ERROR_QUATERNION)),
            feedthrough=bool(d.get("feedthrough_enable", False)),
        )


def geometric_control(p: GeoParams, state13, target_pos, target_vel, target_acc,
                      target_yaw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One control update -> ``(cmd [wx, wy, wz, thrust], q_des)`` over any
    leading batch, on ``state13``'s device and dtype (the targets are moved
    there)."""
    state13 = torch.as_tensor(state13)
    kw = dict(dtype=state13.dtype, device=state13.device)
    target_pos, target_vel, target_acc, target_yaw = (
        torch.as_tensor(t, **kw) for t in (target_pos, target_vel, target_acc, target_yaw))
    pos, vel, q_cur = state13[..., 0:3], state13[..., 3:6], state13[..., 6:10]
    g_vec = torch.zeros_like(pos)
    g_vec[..., 2] = -p.gravity
    kp, kv, drag = (torch.tensor(v, **kw) for v in (p.kp, p.kv, p.drag_d))

    if p.feedthrough:
        a_des = target_acc
    else:
        a_fb = -(kp * (pos - target_pos) + kv * (vel - target_vel))
        n = torch.linalg.norm(a_fb, dim=-1, keepdim=True)
        a_fb = torch.where(n > p.max_fb_acc,
                           a_fb * (p.max_fb_acc / torch.clamp(n, min=1e-9)), a_fb)
        q_ref = quat.acc_yaw_to_q(target_acc - g_vec, target_yaw)
        # rotor drag: R_ref diag(D) R_ref^T v_target
        a_rd = quat.qrotate(q_ref, quat.qrotate_inv(q_ref, target_vel) * drag)
        a_des = a_fb + target_acc - a_rd - g_vec

    q_des = quat.acc_yaw_to_q(a_des, target_yaw)
    ez = torch.zeros_like(pos)
    ez[..., 2] = 1.0
    zb = quat.qrotate(q_cur, ez)
    thrust = torch.clamp(p.norm_thrust_const * torch.sum(a_des * zb, -1)
                         + p.norm_thrust_offset, 0.0, 1.0)

    if p.ctrl_mode == ERROR_GEOMETRIC:
        # the reference's SE(3) error (geometric_controller.cpp:416-417)
        R, Rd = quat.q_to_rotmat(q_cur), quat.q_to_rotmat(q_des)
        e = 0.5 * quat.vee(Rd.transpose(-1, -2) @ R - R.transpose(-1, -2) @ Rd)
        rate = (2.0 / p.attctrl_tau) * e
    else:
        qe = quat.qmul(quat.qconj(q_cur), q_des)
        s = torch.where(qe[..., 0:1] >= 0, 1.0, -1.0).to(qe.dtype)
        rate = (2.0 / p.attctrl_tau) * s * qe[..., 1:4]
    return torch.cat([rate, thrust[..., None]], dim=-1), q_des


# ---- copied from sde4mbrl_px4_tpu/baselines/geometric.py:135-225 -----------
# (the library is loaded by io/mavlink.py::load_native)

class _CGeoParams(ctypes.Structure):
    _fields_ = [
        ("attctrl_tau", ctypes.c_double),
        ("norm_thrust_const", ctypes.c_double),
        ("norm_thrust_offset", ctypes.c_double),
        ("max_fb_acc", ctypes.c_double),
        ("gravity", ctypes.c_double),
        ("drag_d", ctypes.c_double * 3),
        ("Kp", ctypes.c_double * 3),
        ("Kv", ctypes.c_double * 3),
        ("ctrl_mode", ctypes.c_int),
        ("feedthrough", ctypes.c_int),
    ]


class NativeGeometricController:
    """C++ geometric controller + trajectory follower (real-time host path)."""

    def __init__(self, params: GeoParams = GeoParams()):
        self.lib = load_native()
        if self.lib is None:
            raise RuntimeError("csrc/libmpc_native.so not built (run: make -C csrc)")
        self.lib.geo_traj_load.restype = ctypes.c_void_p
        self.lib.geo_traj_sample.restype = ctypes.c_int
        self._p = _CGeoParams()
        self.lib.geo_params_default(ctypes.byref(self._p))
        self.set_params(params)
        self._traj = None

    def set_params(self, p: GeoParams):
        self._p.attctrl_tau = p.attctrl_tau
        self._p.norm_thrust_const = p.norm_thrust_const
        self._p.norm_thrust_offset = p.norm_thrust_offset
        self._p.max_fb_acc = p.max_fb_acc
        self._p.gravity = p.gravity
        for i in range(3):
            self._p.drag_d[i] = p.drag_d[i]
            self._p.Kp[i] = p.kp[i]
            self._p.Kv[i] = p.kv[i]
        self._p.ctrl_mode = p.ctrl_mode
        self._p.feedthrough = int(p.feedthrough)

    def load_params_file(self, path: str) -> bool:
        """Per-key hot reload from a flat config file (reference
        ``loadParameters`` semantics)."""
        rc = self.lib.geo_params_load(ctypes.byref(self._p), path.encode())
        return rc == 0

    def load_trajectory(self, csv_path: str) -> bool:
        h = self.lib.geo_traj_load(os.path.expanduser(csv_path).encode())
        if not h:
            return False
        if self._traj:
            self.lib.geo_traj_free(ctypes.c_void_p(self._traj))
        self._traj = h
        return True

    def sample_trajectory(self, t: float):
        if self._traj is None:
            return None
        pos = (ctypes.c_double * 3)()
        vel = (ctypes.c_double * 3)()
        acc = (ctypes.c_double * 3)()
        yaw = ctypes.c_double()
        self.lib.geo_traj_sample(ctypes.c_void_p(self._traj), ctypes.c_double(t),
                                 pos, vel, acc, ctypes.byref(yaw))
        return (np.array(pos[:]), np.array(vel[:]), np.array(acc[:]), yaw.value)

    def update(self, state13, target_pos, target_vel, target_acc, target_yaw):
        """One control update -> (cmd[4] = [wx,wy,wz,thrust], q_des[4])."""
        st = (ctypes.c_double * 13)(*np.asarray(state13, np.float64))
        tp = (ctypes.c_double * 3)(*np.asarray(target_pos, np.float64))
        tv = (ctypes.c_double * 3)(*np.asarray(target_vel, np.float64))
        ta = (ctypes.c_double * 3)(*np.asarray(target_acc, np.float64))
        cmd = (ctypes.c_double * 4)()
        qd = (ctypes.c_double * 4)()
        self.lib.geo_control_update(ctypes.byref(self._p), st, tp, tv, ta,
                                    ctypes.c_double(float(target_yaw)), cmd, qd)
        return np.array(cmd[:]), np.array(qd[:])

    def __del__(self):
        if getattr(self, "_traj", None) and getattr(self, "lib", None):
            self.lib.geo_traj_free(ctypes.c_void_p(self._traj))

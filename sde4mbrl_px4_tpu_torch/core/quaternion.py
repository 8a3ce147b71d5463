"""Quaternion / rotation math on torch tensors (L0).

PyTorch counterpart of ``sde4mbrl_px4_tpu/core/quaternion.py``: the subset
the model, the cost, the frame conversion, the trajectory loader and the
geometric baseline and the mission layer use.
Quaternions are ``(..., 4)`` tensors in scalar-first ``[w, x, y, z]`` order
and every function broadcasts over leading batch dimensions; all of them
are differentiable with autograd and traceable by ``torch.func.vmap``.
"""
from __future__ import annotations

import torch

__all__ = [
    "cross",
    "qmul",
    "qmul_omega",
    "qconj",
    "qnormalize",
    "qrotate",
    "qrotate_inv",
    "rotmat_to_q",
    "q_to_rotmat",
    "vee",
    "q_from_yaw",
    "q_from_euler",
    "yaw_from_q",
    "acc_yaw_to_q",
    "qerr_vec",
]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qmul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q ⊗ p``."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def qmul_omega(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """``0.5 * q ⊗ [0, omega]`` (quaternion kinematics), in vector form:
    ``0.5 * [-q_v·ω, q_w ω + q_v × ω]``."""
    qw, qv = q.split((1, 3), dim=-1)
    return 0.5 * torch.cat([-torch.sum(qv * omega, dim=-1, keepdim=True),
                            qw * omega + cross(qv, omega)], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate ``[w, -x, -y, -z]``."""
    w, u = q.split((1, 3), dim=-1)
    return torch.cat([w, -u], dim=-1)


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to unit norm (guarded against zero norm)."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` (..., 3) by unit quaternion ``q``: ``v + 2 u x (u x v + w v)``."""
    w, u = q.split((1, 3), dim=-1)
    t = cross(u, v) + w * v
    return v + 2.0 * cross(u, t)


def qrotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of unit quaternion ``q`` (R(q)^T v)."""
    return qrotate(qconj(q), v)


def rotmat_to_q(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, branch-free (four pivots in
    parallel, the largest selected with ``where``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _s(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    s_w = _s(tr + 1.0)
    s_x = _s(1.0 + m00 - m11 - m22)
    s_y = _s(1.0 + m11 - m00 - m22)
    s_z = _s(1.0 + m22 - m00 - m11)

    q_w = torch.stack([0.25 * s_w, (m21 - m12) / s_w, (m02 - m20) / s_w, (m10 - m01) / s_w], -1)
    q_x = torch.stack([(m21 - m12) / s_x, 0.25 * s_x, (m01 + m10) / s_x, (m02 + m20) / s_x], -1)
    q_y = torch.stack([(m02 - m20) / s_y, (m01 + m10) / s_y, 0.25 * s_y, (m12 + m21) / s_y], -1)
    q_z = torch.stack([(m10 - m01) / s_z, (m02 + m20) / s_z, (m12 + m21) / s_z, 0.25 * s_z], -1)

    cond_w = (tr > 0.0)[..., None]
    cond_x = torch.logical_and(m00 > m11, m00 > m22)[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, q_w,
                    torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    return qnormalize(q)


def q_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3), the original's
    ``:93-114`` (the reference's ``quat2RotMatrix``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def vee(m: torch.Tensor) -> torch.Tensor:
    """The 3-vector of a skew-symmetric matrix (the original's ``:229-232``,
    the reference's ``matrix_hat_inv``)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def q_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Pure-yaw quaternion ``[cos(y/2), 0, 0, sin(y/2)]``."""
    h = 0.5 * yaw
    z = torch.zeros_like(yaw)
    return torch.stack([torch.cos(h), z, z, torch.sin(h)], dim=-1)


def yaw_from_q(q: torch.Tensor) -> torch.Tensor:
    """Extract yaw (ZYX convention) from a quaternion."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def q_from_euler(roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """ZYX (yaw-pitch-roll) Euler angles -> quaternion."""
    cr, sr = torch.cos(0.5 * roll), torch.sin(0.5 * roll)
    cp, sp = torch.cos(0.5 * pitch), torch.sin(0.5 * pitch)
    cy, sy = torch.cos(0.5 * yaw), torch.sin(0.5 * yaw)
    return torch.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], dim=-1)


def acc_yaw_to_q(acc: torch.Tensor, yaw: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Differential-flatness attitude: body z along ``acc``, body x projected
    onto the yaw heading."""
    proj_x = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)

    def _unit(v):
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)

    zb = _unit(acc)
    yb = _unit(cross(zb, proj_x))
    xb = _unit(cross(yb, zb))
    R = torch.stack([xb, yb, zb], dim=-1)  # columns are the body axes
    return rotmat_to_q(R)


def qerr_vec(q: torch.Tensor, q_ref: torch.Tensor) -> torch.Tensor:
    """Attitude-error 3-vector: vector part of ``q_ref^{-1} ⊗ q``, sign
    corrected by ``sign(w_err)`` (zero counts as positive)."""
    qe = qmul(qconj(q_ref), q)
    s = torch.where(qe[..., 0:1] < 0, -1.0, 1.0).to(qe.dtype)
    return s * qe[..., 1:4]

"""ENU <-> NED frame conversion for the 13-dim vehicle state (L0).

PyTorch counterpart of ``sde4mbrl_px4_tpu/core/frames.py`` (``:68-80``):
world ENU ``(x_e, y_n, z_up)`` <-> NED ``(x_n, y_e, z_down)``, body FLU <->
FRD, attitude ``q' = Q_NED_ENU ⊗ q ⊗ Q_FLU_FRD``, body rates with y and z
negated. The conversion is an involution, so both directions are the same
function. State layout: ``[x,y,z, vx,vy,vz, qw,qx,qy,qz, wx,wy,wz]``.
"""
from __future__ import annotations

import torch

from sde4mbrl_px4_tpu_torch.core.quaternion import qmul, qnormalize

__all__ = ["enu2ned", "ned2enu", "Q_NED_ENU", "Q_FLU_FRD"]

_SQ2 = 0.7071067811865476
Q_NED_ENU = (0.0, _SQ2, _SQ2, 0.0)   # 180° about (1,1,0)/√2; its own inverse
Q_FLU_FRD = (0.0, 1.0, 0.0, 0.0)     # 180° about body x


def _swap_flip(v: torch.Tensor) -> torch.Tensor:
    """(x,y,z) -> (y,x,-z)."""
    return torch.stack([v[..., 1], v[..., 0], -v[..., 2]], dim=-1)


def _convert_state(x: torch.Tensor) -> torch.Tensor:
    q_ne = torch.tensor(Q_NED_ENU, dtype=x.dtype, device=x.device)
    q_lf = torch.tensor(Q_FLU_FRD, dtype=x.dtype, device=x.device)
    q_new = qnormalize(qmul(qmul(q_ne, x[..., 6:10]), q_lf))
    w = x[..., 10:13]
    w_new = torch.stack([w[..., 0], -w[..., 1], -w[..., 2]], dim=-1)
    return torch.cat([_swap_flip(x[..., 0:3]), _swap_flip(x[..., 3:6]),
                      q_new, w_new], dim=-1)


def enu2ned(x: torch.Tensor) -> torch.Tensor:
    """Full 13-state ENU(world)/FLU(body) -> NED(world)/FRD(body)."""
    return _convert_state(torch.as_tensor(x))


def ned2enu(x: torch.Tensor) -> torch.Tensor:
    """Full 13-state NED/FRD -> ENU/FLU (inverse of :func:`enu2ned`)."""
    return _convert_state(torch.as_tensor(x))

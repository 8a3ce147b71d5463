"""Canonical state/control layout and small typed containers (L0).

PyTorch counterpart of ``sde4mbrl_px4_tpu/core/types.py``. State is the
13-vector ``[x, y, z, vx, vy, vz, qw, qx, qy, qz, wx, wy, wz]``; controls
are per-motor normalized thrusts in ``[1e-4, 1.0]``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

STATE_DIM = 13

# Control-automata states and FollowTraj service modes (same values as the
# JAX package).
CONTROL_STATES = {"none": 0, "reset": 1, "test": 2, "pos": 3, "idle": 4, "traj": 5}
CONTROL_STATE_NAMES = {v: k for k, v in CONTROL_STATES.items()}

CTRL_INACTIVE = 0
CTRL_TRAJ_ACTIVE = 1
CTRL_TRAJ_IDLE = 2
CTRL_POSE_ACTIVE = 3
CTRL_TEST = 4


def hover_state(device: Optional[torch.device | str] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Canonical 13-dim hover/identity state (identity quaternion)."""
    x = torch.zeros(STATE_DIM, dtype=dtype, device=device)
    x[6] = 1.0
    return x


class MPCSolution(NamedTuple):
    """One receding-horizon solve result
    ``(uopt[H,n_u], opt_state', rng', x_evol[H+1,13])``."""

    u_opt: torch.Tensor
    opt_state: object           # solver.apg.APGState
    rng: object                 # torch.Generator (passes through at P=1)
    x_evol: torch.Tensor
